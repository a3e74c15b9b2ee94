"""The C-ABI embedding shim of the PyTorch port (vsearch_tpu_torch/csrc:
capi.c, vsearch_tpu_torch_api.h, capi_demo.c; built by
vsearch_tpu_torch/capi.py) against the JAX package's shim
(native/vsearch_tpu_capi.c, built by tools/build_capi.sh) and
vsearch_tpu.api.

Everything runs on the CPU: the port's shim with
VSEARCH_TPU_TORCH_DEVICE=cpu (every kernel wrapper takes its plain
version), the JAX package's with JAX_PLATFORMS=cpu.  The workload's 520
references put the port's search on the device index (plain K1) and the
top-1 prefetch (plain K2 + K3).  The demos run with their own default
parameters, under which every k-mer of a query is required (a default
Parameters resolves its minimum word matches before its word length): the
exact reads of the workload find their reference, the mutated ones
nothing, on both sides.  The ctypes sessions and the threaded embedder set
the word length to 8, as the reference's api_examples do, so that the
mutated reads find theirs too.  Comparisons are exact: byte-equal output,
field-equal hits.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from . import capi_sessions
from .api_sessions import read_fasta

REPO = pathlib.Path(__file__).resolve().parent.parent

# runs two sessions of the port's shim through ctypes (the second after
# vstpu_api_finalize and vstpu_api_init again, on the first 16 queries)
# and vstpu_dust_single; reports the results, the plain versions the
# first session called and the modules loaded
_DRIVER = """
import json, sys
from tests import capi_sessions as drv
from tests.api_sessions import read_fasta
from vsearch_tpu_torch import capi
from vsearch_tpu_torch.ops import cuda_lib
f = json.load(open(sys.argv[1]))
lib = capi.load()
version = lib.vstpu_api_init()
queries = read_fasta(f["q"])
cuda_lib.reset_launches()
first, nested = drv.search(lib, f["db"], queries, nested=True)
plain, launches = dict(cuda_lib.PLAIN_CALLS), dict(cuda_lib.LAUNCHES)
lib.vstpu_api_finalize()
again = lib.vstpu_api_init()
second, _ = drv.search(lib, f["db"], queries[:16])
dust = drv.dust(lib, [s.encode() for s in f["dust"]])
print(json.dumps({"version": version, "again": again, "first": first,
                  "nested": nested, "second": second, "dust": dust,
                  "plain_calls": plain, "launches": launches,
                  "modules": sorted(sys.modules)}))
"""

ALPHABET = np.frombuffer(b"ACGT", dtype=np.uint8)


def _write_workload(d: pathlib.Path, n_refs=520, n_queries=64, length=150,
                    seed=91):
    """520 random references of 150 nt; 64 queries, the even ones exact
    reads (a window of 100-150 nt) of a reference, the odd ones copies at
    about 95 % identity (substitutions and single-base indels)."""
    rng = np.random.default_rng(seed)
    refs = ALPHABET[rng.integers(0, 4, size=(n_refs, length))]
    db, q = d / "db.fasta", d / "q.fasta"
    db.write_bytes(b"".join(b">r%d\n%s\n" % (i, r.tobytes())
                            for i, r in enumerate(refs)))
    recs = []
    for i in range(n_queries):
        src = refs[rng.integers(0, n_refs)].tobytes()
        if i % 2 == 0:
            w = int(rng.integers(100, length + 1))
            lo = int(rng.integers(0, length - w + 1))
            seq = src[lo:lo + w]
        else:
            s = bytearray(src)
            for _ in range(length // 20):
                p = int(rng.integers(0, len(s)))
                r = rng.random()
                base = int(ALPHABET[rng.integers(0, 4)])
                if r < 0.8:
                    s[p] = base
                elif r < 0.9:
                    del s[p]
                else:
                    s.insert(p, base)
            seq = bytes(s)
        recs.append(b">q%d\n%s\n" % (i, seq))
    q.write_bytes(b"".join(recs))
    return db, q


def _dust_inputs(seed=92, n=24):
    """Random sequences with low-complexity stretches: homopolymers and
    di- and trinucleotide repeats of 20-60 nt, some lower case."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 4))):
            parts.append(ALPHABET[rng.integers(0, 4, size=int(
                rng.integers(10, 80)))].tobytes())
            unit = ALPHABET[rng.integers(0, 4, size=int(
                rng.integers(1, 4)))].tobytes()
            parts.append(unit * (int(rng.integers(20, 61)) // len(unit)))
        seq = b"".join(parts).decode()
        out.append(seq.lower() if i % 5 == 4 else seq)
    return out


def _env(**extra):
    from vsearch_tpu_torch import capi
    env = capi.embed_env()
    env["OMP_NUM_THREADS"] = "1"
    env.pop("VSEARCH_TPU_TORCH_DEVICE", None)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("capi")
    db, q = _write_workload(d)
    return {"dir": d, "db": db, "q": q, "queries": read_fasta(q),
            "dust": _dust_inputs()}


@pytest.fixture(scope="module")
def built():
    from vsearch_tpu_torch import capi
    return capi.build()


@pytest.fixture(scope="module")
def shim_run(workload, built):
    """The ctypes run's report (one subprocess on the CPU device)."""
    spec = workload["dir"] / "spec.json"
    spec.write_text(json.dumps({"db": str(workload["db"]),
                                "q": str(workload["q"]),
                                "dust": workload["dust"]}))
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, str(spec)], cwd=workload["dir"],
        env=_env(VSEARCH_TPU_TORCH_DEVICE="cpu"), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_hits(workload):
    """vsearch_tpu.api.SearchSession.search of every query, in process,
    with the ctypes sessions' parameters."""
    from vsearch_tpu import api
    from vsearch_tpu.params import Parameters
    p = Parameters()
    for name, value in capi_sessions.OPTIONS.items():
        setattr(p, "opt_" + name, value)
    api.session_begin(p)
    try:
        db, index = api.read_database(str(workload["db"]), p)
        ss = api.SearchSession(p, db, index)
        out = []
        for head, seq in workload["queries"]:
            rows = []
            for h in ss.search(head, seq):
                row = {k: getattr(h, k) for k in capi_sessions.FIELDS}
                row["target_label"] = db.getheader(h.target).decode(
                    "latin-1")
                row["cigar"] = h.cigar
                rows.append(row)
            out.append(rows)
    finally:
        api.session_end()
    return out


def test_build_port_shim(built, tmp_path, monkeypatch):
    """capi.build compiles the shim and the demo into the build
    directory, again when a source is newer (checked on a copy of the
    sources); the kernels' builder (csrc/*.cu by name) does not pick the
    C sources up."""
    import shutil
    from vsearch_tpu_torch import capi
    from vsearch_tpu_torch.ops import cuda_lib
    lib, demo = built
    assert lib == capi.LIB and demo == capi.DEMO
    assert lib.is_file() and os.access(demo, os.X_OK)
    assert capi.BUILD_DIR.parent == cuda_lib.BUILD_DIR
    sources = set(cuda_lib.SOURCES.values())
    assert not {p.stem for p in capi.CSRC.glob("*.[ch]")} & sources
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("capi.c", "capi_demo.c", capi.HEADER.name):
        shutil.copy(capi.CSRC / name, csrc / name)
    monkeypatch.setattr(capi, "CSRC", csrc)
    monkeypatch.setattr(capi, "HEADER", csrc / capi.HEADER.name)
    monkeypatch.setattr(capi, "BUILD_DIR", out)
    monkeypatch.setattr(capi, "LIB", out / capi.LIB.name)
    monkeypatch.setattr(capi, "DEMO", out / capi.DEMO.name)
    copy = capi.build()
    assert copy == (capi.LIB, capi.DEMO)
    before = capi.LIB.stat().st_mtime_ns
    src = csrc / "capi.c"
    os.utime(src, ns=(before + 10 ** 9, before + 10 ** 9))
    assert capi.build() == copy
    assert capi.LIB.stat().st_mtime_ns > before


def test_jax_shim_builds_outside_native(tmp_path):
    """tools/build_capi.sh writes into the directory it is given and
    leaves native/ as it was."""
    native = REPO / "native"
    state = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    r = subprocess.run(["sh", str(REPO / "tools" / "build_capi.sh"),
                        str(tmp_path)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "libvsearch_tpu_capi.so").is_file()
    assert (tmp_path / "capi_demo").is_file()
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == state


def test_demo_matches_jax_demo(workload, built, tmp_path):
    """The port's demo and the JAX package's, the same arguments on the
    same data: stdout byte-equal and not empty."""
    r = subprocess.run(["sh", str(REPO / "tools" / "build_capi.sh"),
                        str(tmp_path)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    args = [str(workload["db"]), str(workload["q"]), "0.9"]
    jax = subprocess.run([str(tmp_path / "capi_demo")] + args,
                         env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                         timeout=600)
    assert jax.returncode == 0, jax.stderr.decode()[-2000:]
    port = subprocess.run([str(built[1])] + args,
                          env=_env(VSEARCH_TPU_TORCH_DEVICE="cpu"),
                          capture_output=True, timeout=600)
    assert port.returncode == 0, port.stderr.decode()[-2000:]
    assert port.stdout == jax.stdout
    # the exact reads find their reference, the mutated ones nothing
    heads = [ln.split(b"\t")[0] for ln in port.stdout.splitlines()]
    assert len(heads) == 32
    assert all(int(h[1:]) % 2 == 0 for h in heads)


def test_hits_match_jax_api(shim_run, jax_hits, workload):
    """Every vstpu_hit_t field of the port's shim, cigar and strand among
    them, equals vsearch_tpu.api's result; the shim's process ran the
    plain K1, K2 and K3 and loaded neither jax nor vsearch_tpu."""
    assert shim_run["version"] > 0
    assert shim_run["first"] == jax_hits
    assert sum(map(len, jax_hits)) > 48
    plain = shim_run["plain_calls"]
    assert all(plain[k] > 0
               for k in ("score_dense", "nw_rowscan", "nw_backtrack")), plain
    assert not any(shim_run["launches"].values())
    loaded = shim_run["modules"]
    assert "vsearch_tpu_torch.api" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "vsearch_tpu" or m.startswith("vsearch_tpu.")]


def test_dust_matches_jax(shim_run, workload):
    from vsearch_tpu import api
    want = [api.dust_single(s.encode()).decode() for s in workload["dust"]]
    assert shim_run["dust"] == want
    # the inputs' repeats were masked
    assert sum(c.islower() for s in want for c in s) > 500


def test_sequential_sessions_and_nested_begin(shim_run):
    """A second begin inside a session returns -1 at once; a second
    session after vstpu_api_finalize and vstpu_api_init gives the first
    one's rows."""
    assert shim_run["nested"] == -1
    assert shim_run["again"] == shim_run["version"]
    assert shim_run["second"] == shim_run["first"][:16]


def test_two_thread_embedder(workload, shim_run, tmp_path):
    """A C embedder whose main thread initializes the shim and joins two
    pthreads that search (tests/capi_threads.c) finishes, with the rows of
    the one-thread session."""
    from vsearch_tpu_torch import capi
    exe = capi.compile_embedder(REPO / "tests" / "capi_threads.c",
                                tmp_path / "capi_threads")
    args = [str(workload["db"]), str(workload["q"]), "0.9"] + [
        "%s=%s" % kv for kv in capi_sessions.OPTIONS.items() if kv[0] != "id"]
    r = subprocess.run([str(exe)] + args,
                       env=_env(VSEARCH_TPU_TORCH_DEVICE="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == capi_sessions.tsv(workload["queries"],
                                       shim_run["first"])


def _declarations(path: pathlib.Path) -> str:
    """A header's text without comments, preprocessor lines and
    whitespace runs."""
    text = re.sub(r"/\*.*?\*/", " ", path.read_text(), flags=re.S)
    text = "\n".join(ln for ln in text.splitlines()
                     if not ln.lstrip().startswith("#"))
    return " ".join(text.split())


def test_header_declarations_match_jax():
    from vsearch_tpu_torch import capi
    port = _declarations(capi.HEADER)
    assert port == _declarations(REPO / "native" / "vsearch_tpu_api.h")
    assert "vstpu_search_single" in port and "vstpu_hit_t" in port


def test_demo_fails_without_card(workload, built):
    """Without a card and without VSEARCH_TPU_TORCH_DEVICE=cpu the shim's
    session begin fails with the port's error and the demo exits
    non-zero, printing no row."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([str(built[1]), str(workload["db"]),
                        str(workload["q"]), "0.9"], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "vstpu_session_begin" in r.stderr
    assert "no CUDA device" in r.stderr

"""Multi-process scale-out of the port: N torch.distributed ranks (gloo, on
the CPU) against the port's single-process run and the JAX package.

The port runs under torchrun (tests/parallel_driver.py, one launch of 2
ranks, one of 4 and one single process, all at once, every kernel wrapper
on its plain version), the JAX package in process.  Every output of rank 0
must be byte-equal to the single-process run's and to vsearch_tpu's: the
static index sharded over the ranks (an 800-sequence DB leaves the upper
shards empty), the growing index sharded for clustering and de novo
chimera detection, the pair-sharded aligner on both wires, a session, and
the dry run's sharded_count_topk and sharded_nw_scores.  At the default
NATIVE_CELLS_LIMIT the ranks route every alignment batch alike with no
collective of their own: the route reads the batch alone.  Each rank
reports the sharded classes it built, its collectives, and that it
loaded neither jax nor vsearch_tpu.  A 2-rank launch checks that the
group's teardown at exit joins gloo's worker threads before Python
finalizes.  These are the counterparts of tests/test_multichip.py and
tests/test_distributed.py.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from . import api_sessions
from .chimera_workload import write_ref_workload
from .conftest import run_ours
from .test_device_search_parity import _write_workload
from .test_torch_cluster import families  # noqa: F401 (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
DRIVER = REPO / "tests" / "parallel_driver.py"

SETUP = ("from vsearch_tpu_torch.core.chimera import ChimeraEngine\n"
         "from vsearch_tpu_torch.core.cluster import ClusterEngine\n"
         "from vsearch_tpu_torch.ops.nw_batch import BatchAligner\n"
         "ChimeraEngine.DEVICE_MIN = 16\n"
         "ClusterEngine.DEVICE_MIN = 16\n"
         "LIMIT = BatchAligner.NATIVE_CELLS_LIMIT\n")
CELLS_LIMIT = "BatchAligner.NATIVE_CELLS_LIMIT = %s\n"
# every walk round on the (plain) device aligner
ALL_DEVICE = CELLS_LIMIT % 0
# alignment calls above 70 000 DP cells on the plain kernels, the rest on
# the host (tests/test_torch_chimera.py)
CHIMERA = CELLS_LIMIT % 70000
# the default limit
DEFAULT = CELLS_LIMIT % "LIMIT"

# the family set searched against itself: each query's family gives its
# walk rounds
SEARCH = ["--id", "0.8", "--strand", "both", "--maxaccepts", "4",
          "--maxrejects", "16"]
# name -> (argv with {inputs}, outputs, setup, world sizes)
CASES = {
    "search": (["--usearch_global", "{fam}", "--db", "{fam}"] + SEARCH,
               ("uc", "blast6out"), ALL_DEVICE, (2, 4)),
    "search_mm200": (["--usearch_global", "{fam}", "--db", "{fam}"] + SEARCH
                     + ["--mismatch", "-200"], ("uc", "blast6out"),
                     ALL_DEVICE, (2, 4)),
    "cluster_size": (["--cluster_size", "{fam}", "--id", "0.97"],
                     ("uc", "centroids"), DEFAULT, (2,)),
    "uchime3_denovo": (["--uchime3_denovo", "{chim}"],
                       ("uchimeout", "chimeras", "nonchimeras"), CHIMERA,
                       (2,)),
    "uchime_ref": (["--uchime_ref", "{ref_q}", "--db", "{ref_db}"],
                   ("uchimeout", "chimeras", "nonchimeras"), CHIMERA,
                   (2,)),
}

SESSION = """
from tests import api_sessions
from vsearch_tpu_torch import api
from vsearch_tpu_torch.params import Parameters
from vsearch_tpu_torch.parallel.distributed import output_path
result = {"search": api_sessions.search(api, Parameters, %r, %r, "cpu"),
          "out": output_path("out.uc")}
"""

# the dry run's functions on seeded inputs: 16 words of positions split
# over the ranks, and 64 pairs
SHARDED_FNS = """
import numpy as np, torch
from vsearch_tpu_torch.parallel import mesh as M
from vsearch_tpu_torch.ops.nw_batch import encode_padded, encode_rowT
rng = np.random.default_rng(41)
A = torch.from_numpy(rng.integers(0, 2, (8, 256)).astype(np.int8))
bits = torch.from_numpy(rng.integers(0, 2**32, (256, 16), dtype=np.uint64)
                        .astype(np.uint32).view(np.int32))
w = 16 // world
counts, idx = M.sharded_count_topk(M.active_mesh(), A,
                                   bits[:, rank * w:(rank + 1) * w], 5)
acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
qs = [acgt[rng.integers(0, 4, rng.integers(20, 60))].tobytes()
      for _ in range(64)]
ts = [acgt[rng.integers(0, 4, rng.integers(20, 60))].tobytes()
      for _ in range(64)]
qmT, amT = encode_rowT(qs, 64, 64, -4, False)
t4T = np.ascontiguousarray(encode_padded(ts, 64, 64).T)
key = (2, -4, 20, 20, 20, 20, 20, 20, 2, 2, 2, 2, 2, 2, 0)
score, over = M.sharded_nw_scores(
    M.active_mesh(), key, torch.from_numpy(qmT), torch.from_numpy(amT),
    torch.tensor([len(s) for s in qs], dtype=torch.int32),
    torch.from_numpy(t4T),
    torch.tensor([len(s) for s in ts], dtype=torch.int32))
result = {"counts": counts.tolist(), "idx": idx.tolist(),
          "score": score.tolist(), "overflow": over.tolist()}
"""


def _argv(case, files, tag):
    args, outs, _, _ = CASES[case]
    return [a.format(**files) for a in args] + [
        x for o in outs for x in ("--" + o, str(files["dir"] / (
            "%s.%s.%s" % (tag, case, o))))] + ["--threads", "1", "--quiet"]


def _spec(files, world):
    tag = "w%d" % world
    runs = [{"name": case, "setup": setup, "argv": _argv(case, files, tag)}
            for case, (_, _, setup, worlds) in CASES.items()
            if world == 1 or world in worlds]
    if world != 4:
        runs.append({"name": "session", "setup": ALL_DEVICE,
                     "code": SESSION % (str(files["db"]), str(files["q"]))})
    runs.append({"name": "sharded_fns", "code": SHARDED_FNS})
    if world == 2:
        runs.append({"name": "router", "setup": DEFAULT,
                     "argv": _argv("search", files, "router")})
    path = files["dir"] / ("%s.json" % tag)
    path.write_text(json.dumps({"setup": SETUP, "runs": runs,
                                "report": str(files["dir"] / tag)}))
    return path


def _env():
    """A launch's environment: the port on the CPU, no rank variables of
    an enclosing launch."""
    env = dict(os.environ)
    env["VSEARCH_TPU_TORCH_DEVICE"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    return env


def _launch(files, world):
    cmd = [sys.executable]
    if world > 1:
        # each rank's stderr in a file of its own (_failure)
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(world), "--log-dir",
                str(files["dir"] / ("logs.w%d" % world)), "--redirects", "2"]
    # a session of its own, so that a failure stops every rank
    return subprocess.Popen(cmd + [str(DRIVER), str(_spec(files, world))],
                            cwd=files["dir"], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _failure(d, world, rc, err):
    """A failed launch: its world size and exit code, the launcher's
    stderr and every rank's."""
    parts = ["the %d-rank launch exited %d" % (world, rc), err[-4000:]]
    for log in sorted((d / ("logs.w%d" % world)).glob(
            "*/attempt_*/*/stderr.log")):
        parts.append("rank %s stderr:\n%s" % (log.parent.name,
                                               log.read_text()[-4000:]))
    return "\n".join(parts)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, families):  # noqa: F811 (fixture)
    """The inputs, the JAX package's outputs and session, and each world
    size's per-rank reports."""
    d = tmp_path_factory.mktemp("parallel")
    files = {"dir": d, "fam": families}
    files["db"], files["q"] = _write_workload(d)
    files["chim"], files["ref_q"], files["ref_db"] = write_ref_workload(d)
    procs = {w: _launch(files, w) for w in (1, 2, 4)}
    try:
        # the JAX package meanwhile, in process
        for case in CASES:
            run_ours(_argv(case, files, "jax")[:-3], d)
        from vsearch_tpu import api
        from vsearch_tpu.params import Parameters
        jax_session = api_sessions.search(api, Parameters, str(files["db"]),
                                          str(files["q"]))
        reports = {}
        for w, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, _failure(d, w, proc.returncode,
                                                  err)
            reports[w] = [json.loads((d / ("w%d.rank%d.json" % (w, r)))
                                     .read_text())
                          for r in range(w)]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    return files, reports, jax_session


def _run(report, name):
    return next(r for r in report["runs"] if r["name"] == name)


def _check_ranks(reports, name, sharded):
    for rep in reports:
        run = _run(rep, name)
        assert not rep["foreign_modules"], rep["foreign_modules"]
        assert run["collectives"]["all_gather"] > 0, run
        if sharded:
            assert run["built"].get(sharded) == 1, run["built"]
        assert not any(run["launches"].values())


@pytest.mark.parametrize("case,world", [
    (case, w) for case, (_, _, _, worlds) in CASES.items() for w in worlds])
def test_outputs_match(runs, case, world):
    files, reports, _ = runs
    d = files["dir"]
    for o in CASES[case][1]:
        jax_out = (d / ("jax.%s.%s" % (case, o))).read_bytes()
        assert jax_out, o
        assert (d / ("w1.%s.%s" % (case, o))).read_bytes() == jax_out, o
        assert (d / ("w%d.%s.%s" % (world, case, o))).read_bytes() \
            == jax_out, o
    sharded = {"search": "ShardedKmerIndex",
               "uchime_ref": "ShardedKmerIndex",
               "cluster_size": "ShardedGrowingKmerIndex",
               "uchime3_denovo": "ShardedGrowingKmerIndex"}.get(case)
    _check_ranks(reports[world], case, sharded)
    # every rank ran the kernels of the path (their plain versions here)
    kernels = {"search": ("score_dense", "nw_rowscan", "nw_backtrack"),
               "search_mm200": ("score_dense", "nw_wavefront",
                                "nw_backtrack_flat"),
               "cluster_size": ("score_ranked", "nw_rowscan",
                                "nw_backtrack"),
               "uchime3_denovo": ("score_ranked",),
               "uchime_ref": ("score_dense",)}[case]
    for rep in reports[world]:
        plain = _run(rep, case)["plain_calls"]
        assert all(plain[k] > 0 for k in kernels), (rep["rank"], plain)
    assert _run(reports[1][0], case)["collectives"]["all_gather"] == 0


def test_session_matches(runs):
    files, reports, jax_session = runs
    single = _run(reports[1][0], "session")["result"]
    ranked = [_run(rep, "session")["result"] for rep in reports[2]]
    assert single["search"] == jax_session
    assert ranked[0]["search"] == jax_session
    assert ranked[1]["search"] == jax_session
    # rank 0 alone writes output files
    assert single["out"] == ranked[0]["out"] == "out.uc"
    assert ranked[1]["out"] == os.devnull
    _check_ranks(reports[2], "session", "ShardedKmerIndex")


def test_ranks_route_alike_without_a_collective(runs):
    """The search at the default NATIVE_CELLS_LIMIT on two ranks: each
    rank routes every alignment batch from the batch alone, so both make
    the same plain kernel calls and no collective but the all-gathers of
    the sharded work, and the run finishes with the single-process
    bytes."""
    files, reports, _ = runs
    d = files["dir"]
    for o in CASES["search"][1]:
        assert (d / ("router.search.%s" % o)).read_bytes() \
            == (d / ("w1.search.%s" % o)).read_bytes(), o
    ranks = [_run(rep, "router") for rep in reports[2]]
    assert ranks[0]["plain_calls"] == ranks[1]["plain_calls"]
    assert all(set(run["collectives"]) == {"all_gather"} for run in ranks)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fns_match_single_rank(runs, world):
    _, reports, _ = runs
    one = _run(reports[1][0], "sharded_fns")["result"]
    for rep in reports[world]:
        got = _run(rep, "sharded_fns")["result"]
        assert got["score"] == one["score"]
        assert got["overflow"] == one["overflow"]
        # each rank's top-5 candidates, gathered: their exact merge is the
        # single rank's top-5
        for c1, i1, cs, ix in zip(one["counts"], one["idx"], got["counts"],
                                  got["idx"]):
            assert len(cs) == 5 * world
            merged = sorted(zip(cs, ix), key=lambda ci: (-ci[0], ci[1]))[:5]
            assert merged == list(zip(c1, i1))


def test_sharded_fns_match_numpy(runs):
    """The single rank's counts are the plain product's: every bit of the
    seeded matrix counted, the top-5 by (count desc, position asc)."""
    _, reports, _ = runs
    one = _run(reports[1][0], "sharded_fns")["result"]
    rng = np.random.default_rng(41)
    A = rng.integers(0, 2, (8, 256)).astype(np.int64)
    bits = rng.integers(0, 2**32, (256, 16), dtype=np.uint64)
    unpacked = ((bits[:, :, None] >> np.arange(32, dtype=np.uint64)) & 1) \
        .reshape(256, 512).astype(np.int64)
    counts = A @ unpacked
    for q in range(8):
        order = np.lexsort((np.arange(512), -counts[q]))[:5]
        assert one["idx"][q] == order.tolist()
        assert one["counts"][q] == counts[q][order].tolist()


# a rank that gathers once and exits; a handler registered before the
# group forms runs after the port's teardown and lists the backend's
# threads that are left
TEARDOWN = """
import atexit, json, os, sys
def gloo_threads():
    names = (open("/proc/self/task/%s/comm" % t).read().strip()
             for t in os.listdir("/proc/self/task"))
    return sorted(n for n in names if "gloo" in n)
def report():
    with open("teardown.rank%s.json" % os.environ["RANK"], "w") as fh:
        json.dump({"running": running, "at_exit": gloo_threads()}, fh)
atexit.register(report)
import torch
from vsearch_tpu_torch.parallel import distributed, mesh
distributed.maybe_initialize()
m = mesh.active_mesh()
got = m.all_gather(torch.full((4,), m.rank, dtype=torch.int32))
assert got.tolist() == [r for r in range(m.size) for _ in range(4)]
running = gloo_threads()
"""


def test_exit_joins_the_backend_threads(tmp_path):
    """The group is torn down at exit before Python finalizes: no gloo
    worker thread is left to take the GIL afterwards (one that does is
    unwound through C++, and the rank aborts with "terminate called
    without an active exception")."""
    script = tmp_path / "teardown.py"
    script.write_text(TEARDOWN)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(script)], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for r in range(2):
        rep = json.loads((tmp_path / ("teardown.rank%d.json" % r))
                         .read_text())
        assert "pt_gloo_runloop" in rep["running"], rep
        assert rep["at_exit"] == [], rep


def test_local_device_follows_local_rank():
    """A rank on a node of four cards runs on cuda:LOCAL_RANK (the thread's
    current device, which the launches follow), or on the device it
    names; a LOCAL_RANK past the cards raises."""
    from vsearch_tpu_torch.parallel.distributed import local_device
    assert local_device("cuda", 3, 4) == torch.device("cuda", 3)
    assert local_device("cuda:0", 3, 4) == torch.device("cuda", 0)
    assert local_device("cpu", 3, 0) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        local_device("cuda", 4, 4)


def test_entry_point_keeps_the_rank_device(monkeypatch):
    """Under a process group an entry point runs on the rank's device,
    and a request for another device raises; without one it selects as
    a single process does."""
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, "_device", torch.device("cuda", 1))
    for name in (None, "cuda", "cuda:1"):
        assert distributed.select_device(name) == torch.device("cuda", 1)
    for name in ("cuda:0", "cpu"):
        with pytest.raises(ValueError, match="this rank runs on cuda:1"):
            distributed.select_device(name)
    monkeypatch.setattr(distributed, "_device", None)
    monkeypatch.setattr(device, "_current", None)
    assert distributed.select_device("cpu") == torch.device("cpu")
    assert device.current() == torch.device("cpu")


def test_no_group_runs_the_single_process_path(monkeypatch):
    """Without WORLD_SIZE above 1 nothing starts and no mesh is active."""
    from vsearch_tpu_torch.parallel import distributed, mesh
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(distributed, "_initialized", False)
    assert distributed.maybe_initialize(device="cpu") is False
    assert mesh.active_mesh() is None
    assert distributed.output_path("x.uc") == "x.uc"


def test_torchrun_without_card_raises(tmp_path, monkeypatch):
    """Under torchrun too, without a card and without a request for the
    CPU, the entry point raises before the group forms."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.parallel import distributed
    monkeypatch.delenv(device.ENV, raising=False)
    monkeypatch.setattr(distributed, "_initialized", False)
    for var, val in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                     ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(var, val)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.maybe_initialize()
    assert distributed.rank_device() is None

"""The session API: the PyTorch port's vsearch_tpu_torch.api against
vsearch_tpu.api.

The port's sessions run in one subprocess on its CPU device (every kernel
wrapper takes its plain version; that process is shown to load neither jax
nor vsearch_tpu), the JAX package's in process, both through
tests/api_sessions.py on the same seeded inputs.  Results must be equal
field for field.  The search session's DB of 520 sequences puts it on the
device index (plain K1) and the top-1 prefetch (plain K2 + K3); the
chimera session's 520 references put its part candidates on K1.
"""

import json
import os
import pathlib
import random
import subprocess
import sys

import pytest

from . import api_sessions
from .chimera_workload import write_ref_workload
from .test_device_search_parity import _write_workload
from .test_differential_fuzz import make_fasta, make_pairs

REPO = pathlib.Path(__file__).resolve().parent.parent

# chimera queries detected (each detect() is a one-query round)
CHIMERA_QUERIES = 40

# runs every session of tests/api_sessions.py through the port; reports
# each one's results and the plain versions it called, and the modules
# loaded
_DRIVER = """
import json, sys
from tests import api_sessions as run
from vsearch_tpu_torch import api
from vsearch_tpu_torch.ops import cuda_lib
from vsearch_tpu_torch.params import Parameters
f = json.load(open(sys.argv[1]))
calls = {
    "search": lambda: run.search(api, Parameters, f["db"], f["q"], "cpu"),
    "cluster": lambda: run.cluster(api, Parameters, f["clu"], "cpu"),
    "chimera": lambda: run.chimera(api, Parameters, f["chim_q"],
                                   f["chim_db"], "cpu", %d),
    "derep": lambda: run.derep(api, f["derep"]),
    "merge": lambda: run.merge(api, Parameters, f["fwd"], f["rev"]),
    "dust": lambda: run.dust(api, f["derep"]),
}
out = {}
for name, call in calls.items():
    cuda_lib.reset_launches()
    out[name] = {"results": call(), "plain_calls": dict(cuda_lib.PLAIN_CALLS),
                 "launches": dict(cuda_lib.LAUNCHES)}
print(json.dumps({"sessions": out, "modules": sorted(sys.modules)}))
""" % CHIMERA_QUERIES


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The inputs, and the port's run of every session (one subprocess)."""
    d = tmp_path_factory.mktemp("api")
    files = {}
    files["db"], files["q"] = map(str, _write_workload(d))
    files["clu"] = str(api_sessions.write_cluster_set(d / "clu.fa"))
    _, q, db = write_ref_workload(d)
    files["chim_q"], files["chim_db"] = str(q), str(db)
    files["derep"] = str(d / "derep.fa")
    make_fasta(files["derep"], random.Random(5), 80, minlen=5, maxlen=200,
               amb=0.05, lower=0.2, dupes=0.4)
    files["fwd"], files["rev"] = str(d / "f.fq"), str(d / "r.fq")
    make_pairs(files["fwd"], files["rev"], random.Random(6), 60)
    spec = d / "files.json"
    spec.write_text(json.dumps(files))
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env.pop("VSEARCH_TPU_TORCH_DEVICE", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", _DRIVER, str(spec)],
                          cwd=d, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return files, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture()
def jax_api():
    from vsearch_tpu import api
    from vsearch_tpu.params import Parameters
    return api, Parameters


def test_session_lock():
    from vsearch_tpu_torch import api
    from vsearch_tpu_torch.params import Parameters
    p = Parameters()
    api.session_begin(p, device="cpu")
    with pytest.raises(api.SessionError):
        api.session_begin(p, device="cpu")
    api.session_end()
    # sequential sessions are fine
    with api.session(Parameters(), device="cpu"):
        pass
    with pytest.raises(api.SessionError):
        api.session_end()


def test_api_version():
    from vsearch_tpu import api as jax_api
    from vsearch_tpu_torch import api
    assert api.api_version() == (api.API_VERSION_MAJOR * 1000000
                                 + api.API_VERSION_MINOR * 1000
                                 + api.API_VERSION_PATCH)
    assert api.api_version_string().count(".") == 2
    assert api.api_version() == jax_api.api_version()


def test_session_begin_raises_without_card(monkeypatch):
    """Without a card and without a request for the CPU a session does not
    begin, and leaves the lock free."""
    import torch
    from vsearch_tpu_torch import api, device
    from vsearch_tpu_torch.params import Parameters
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv(device.ENV, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.session_begin(Parameters())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with api.session(Parameters()):
            pass
    with api.session(Parameters(), device="cpu"):
        pass


def test_port_process_loads_neither_jax_nor_vsearch_tpu(port):
    loaded = port[1]["modules"]
    assert "vsearch_tpu_torch.api" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "vsearch_tpu" or m.startswith("vsearch_tpu.")]


def test_search_masks_one_query_as_its_batch(port):
    """JAX's one-query session masks each strand with dust_mask, the port's
    batches with dust_mask_batch: the same bytes on these queries."""
    from vsearch_tpu.core import mask as jax_mask
    from vsearch_tpu_torch.core import mask
    from vsearch_tpu_torch.utils.maps import reverse_complement
    seqs = [s for _, s in api_sessions.read_fasta(port[0]["q"])]
    seqs += [reverse_complement(s) for s in seqs]
    for hard in (False, True):
        batch = mask.dust_mask_batch(seqs, hard)
        assert batch == [mask.dust_mask(s, hard) for s in seqs]
        assert batch == [jax_mask.dust_mask(s, hard) for s in seqs]


def test_search_session_matches_jax(port, jax_api):
    files, rep = port
    got = rep["sessions"]["search"]
    want = api_sessions.search(*jax_api, files["db"], files["q"])
    assert got["results"] == want
    # every query finds its DB sequence, alone or in its batch
    assert len(want["batch"]) == 64 and all(want["batch"])
    assert want["single"] == [row[:3] for row in want["batch"][:16]]
    # the port's device tier ran (its plain versions, on the CPU device)
    assert all(got["plain_calls"][k] > 0 for k in
               ("score_dense", "nw_rowscan", "nw_backtrack")), got
    assert not any(got["launches"].values())


def test_cluster_session_matches_jax(port, jax_api):
    files, rep = port
    got = rep["sessions"]["cluster"]
    want = api_sessions.cluster(*jax_api, files["clu"])
    assert got["results"] == want
    centroids = sum(r["is_centroid"] for r in want)
    assert 12 <= centroids < len(want)


def test_chimera_session_matches_jax(port, jax_api):
    files, rep = port
    got = rep["sessions"]["chimera"]
    want = api_sessions.chimera(*jax_api, files["chim_q"], files["chim_db"],
                                n=CHIMERA_QUERIES)
    assert got["results"] == want
    assert {r["flag"] for r in want} >= {"Y", "N"}
    # part candidates from the static index's K1
    assert got["plain_calls"]["score_dense"] > 0, got


def test_derep_session_matches_jax(port, jax_api):
    files, rep = port
    want = api_sessions.derep(jax_api[0], files["derep"])
    assert rep["sessions"]["derep"]["results"] == want
    assert any(r["count"] > 1 for r in want)


def test_merge_session_matches_jax(port, jax_api):
    files, rep = port
    want = api_sessions.merge(*jax_api, files["fwd"], files["rev"])
    assert rep["sessions"]["merge"]["results"] == want
    assert any(r["merged"] for r in want)


def test_dust_single_matches_jax(port, jax_api):
    files, rep = port
    want = api_sessions.dust(jax_api[0], files["derep"])
    assert rep["sessions"]["dust"]["results"] == want

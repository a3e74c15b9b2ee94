"""The 16-bit overflow bound end to end: --match 1 --mismatch 100, a scheme
whose alignments of 400 nt and more pass SHRT_MAX, through the PyTorch
port and the JAX package on the CPU.

The port's bound (ops/nw_rowscan.py _path_bounds) takes the largest of
match, mismatch and 0 as the best score of a diagonal cell; the JAX
package's row-scan forward (ops/nw_pallas2.py overflow_possible, which
runs only on a TPU) takes max(match, 0), so under a mismatch reward it
drops the tracking there.  Its CPU engines, the host C tier and the XLA
scan, always track.  Here the port runs in a subprocess on its CPU device
with every alignment call sent to its device aligner (its
NATIVE_CELLS_LIMIT 0, plain K2 + K3, K2m's 32-bit body for allpairs), the
JAX package in process; uc, blast6 and userout must be byte-equal.  The port's aligner
must have flagged overflowing pairs (SHRT_MAX sentinels, realigned by the
linear-memory aligner).  Workload: tests/overflow_workload.py.
"""

import dataclasses
import json

import pytest

from .conftest import run_ours
from .overflow_workload import ARGS, write_overflow_workload
from .test_torch_search import run_port

# every alignment call on the device aligner, one CPU thread; the
# overflow counters of overflow_workload.count_overflow, written at exit
SETUP = """
import atexit, json, torch
from tests.overflow_workload import count_overflow
from vsearch_tpu_torch.ops.nw_batch import BatchAligner
torch.set_num_threads(1)
BatchAligner.NATIVE_CELLS_LIMIT = 0
SEEN, _ = count_overflow()
atexit.register(lambda: open("overflow.json", "w").write(json.dumps(SEEN)))
"""

USERFIELDS = ["--userfields", "query+target+id+raw+mism+gaps+qlo+qhi+tlo+"
              "thi+caln"]
# verb arguments (a low --id, so that the reward-maximizing alignments are
# accepted and written), and the kernels whose plain versions must run
CASES = {
    "usearch_global": (["--usearch_global", "{q}", "--db", "{db}", "--id",
                        "0.01", "--maxaccepts", "2", "--maxrejects", "4",
                        "--output_no_hits"],
                       ("score_dense", "nw_rowscan", "nw_backtrack")),
    "allpairs_global": (["--allpairs_global", "{ap}", "--id", "0.01",
                         "--minseqlength", "1"],
                        ("nw_rowscan_mr", "nw_stats", "nw_rowscan",
                         "nw_backtrack")),
}


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    db, q, ap = write_overflow_workload(tmp_path_factory.mktemp("ovf"))
    return {"db": db, "q": q, "ap": ap}


@pytest.mark.parametrize("case", sorted(CASES))
def test_overflow_scheme_matches_jax(workload, tmp_path, case):
    args, kernels = CASES[case]
    args = [a.format(**workload) for a in args] + ARGS

    def outs(side):
        return ["--uc", side + ".uc", "--blast6out", side + ".b6",
                "--userout", side + ".user"] + USERFIELDS

    run_ours(args + outs("jax"), tmp_path)
    rep = run_port(args + outs("port") + ["--threads", "1", "--quiet"],
                   tmp_path, setup=SETUP)
    assert rep["rc"] == 0
    for ext in ("uc", "b6", "user"):
        jax_out = (tmp_path / ("jax." + ext)).read_bytes()
        assert jax_out, ext
        assert (tmp_path / ("port." + ext)).read_bytes() == jax_out, ext
    raws = [int(ln.split(b"\t")[3]) for ln in
            (tmp_path / "port.user").read_bytes().splitlines()]
    assert max(raws) > 32767
    seen = json.loads((tmp_path / "overflow.json").read_text())
    # the port's aligner flagged overflowing pairs
    assert seen["aligner_sentinels"] > 0, seen
    if case == "allpairs_global":
        # the pipeline flagged the long pairs and passed the short ones
        assert seen["allpairs_overflow"] > 0, seen
        assert min(raws) < 32767
    plain = rep["plain_calls"]
    assert all(plain[k] > 0 for k in kernels), plain
    assert plain["nw_rowscan_mr16"] == 0 and plain["nw_wavefront"] == 0
    assert not any(rep["launches"].values())
    loaded = rep["modules"]
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "vsearch_tpu" or m.startswith("vsearch_tpu.")]


def test_aligner_overflow_matches_jax(workload, monkeypatch):
    """The port's BatchAligner on its device path (plain K2 + K3) against
    the JAX package's BatchAligner (its host C tier on the CPU) on the
    allpairs set's pairs: equal results, the long pairs SHRT_MAX
    sentinels, the short ones not.  The port's static bound tracks
    overflow at this shape; the JAX package's row-scan bound, which only
    its TPU forward reads, would not."""
    import torch
    from vsearch_tpu.ops import nw_jax, nw_pallas2
    from vsearch_tpu.ops.nw import ScoreScheme as JaxScheme
    from vsearch_tpu.params import Parameters as JaxParameters
    from vsearch_tpu_torch.ops import nw_batch, nw_rowscan
    from vsearch_tpu_torch.ops.nw import SHRT_MAX, ScoreScheme
    from vsearch_tpu_torch.params import Parameters
    from .api_sessions import read_fasta

    def scheme(cls, params):
        p = params()
        p.apply_defaults_fixups()
        p.opt_match, p.opt_mismatch = 1, 100
        return cls.from_params(p)

    recs = dict(read_fasta(workload["ap"]))
    pairs = [(b"f0", b"f0.sub"), (b"f1", b"f2"), (b"f2.sub", b"f0"),
             (b"short0", b"short3"), (b"f1", b"short2")]
    qs = [recs[a] for a, _ in pairs]
    ts = [recs[b] for _, b in pairs]
    port = nw_batch.BatchAligner(scheme(ScoreScheme, Parameters),
                                 torch.device("cpu"))
    monkeypatch.setattr(nw_batch.BatchAligner, "NATIVE_CELLS_LIMIT", 0)
    got = port.align_pairs(qs, ts)
    want = nw_jax.BatchAligner(
        scheme(JaxScheme, JaxParameters)).align_pairs(qs, ts)
    assert list(map(dataclasses.astuple, got)) == \
        list(map(dataclasses.astuple, want))
    assert [r.score == SHRT_MAX for r in got] == [True] * 3 + [False] * 2
    key = port._key
    assert nw_rowscan.overflow_possible(key, 512, 512)
    assert not nw_pallas2.overflow_possible(key, 512, 512)
    assert not nw_rowscan.rowscan16(key, 512, 512)

"""Chimera detection end to end: the PyTorch port against the JAX package.

The port runs in a subprocess on its CPU device (every kernel wrapper takes
its plain version) with ChimeraEngine.DEVICE_MIN lowered and the aligner's
NATIVE_CELLS_LIMIT set in that process, so that after one host round of 128
queries its growing k-mer index (K4) scores the de novo rounds, several
512-part chunks a round, and the walk waves and full-query batches go
through the plain K2 + K3 (K6 + K7 under --mismatch -200); uchime_ref
scores on the static index (K1).  One case of 32 sequences sends every
alignment call, the same-round repair's single pairs among them, through
the plain K2 + K3.  Its process is shown to load neither jax
nor vsearch_tpu.  The JAX package runs in process.  Outputs must be
byte-equal.
"""

import pathlib

import pytest

from .chimera_workload import write_chimera_workload, write_ref_workload
from .conftest import run_ours
from .test_torch_search import run_port

# device tier from the 16th accepted reference on.  Alignment calls of
# more than NATIVE_CELLS_LIMIT DP cells go to the plain kernels, the smaller
# ones to the host C tier.  The cases on the 800-sequence workload send
# calls above 70 000 cells (about four full queries at 128 x 128: the walk
# waves and the full-query batches) to the plain kernels and the
# same-round repair's single pairs to the host: the plain K2 costs 70-135
# ms a call here whatever its pair count, K6 230-430 ms, and a limit
# of 0 sends thousands of single pairs to them.  One case on a workload
# of 32 sequences sends every call, the repair's single pairs among them,
# to the plain kernels (limit 0)
SETUP = ("from vsearch_tpu_torch.core.chimera import ChimeraEngine\n"
         "from vsearch_tpu_torch.ops.nw_batch import BatchAligner\n"
         "ChimeraEngine.DEVICE_MIN = 16\n"
         "BatchAligner.NATIVE_CELLS_LIMIT = %d")

DATA = pathlib.Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("chimera")
    fa, q, db = write_ref_workload(d)
    # one host round of 32: 6 parents, 3 copies of each, 8 chimeras
    small = d / "small.fa"
    write_chimera_workload(small, seed=21, parents=6, copies=3, chimeras=8)
    # the seeded set with the long-read fixture's parents and chimeras
    long_fa = d / "long.fa"
    long_fa.write_bytes(fa.read_bytes()
                        + (DATA / "chimeras_long.fasta").read_bytes())
    return {"fa": fa, "q": q, "db": db, "long": long_fa,
            "small": small}


UCHIME_OUTS = ("uchimeout", "uchimealns", "chimeras", "nonchimeras",
               "borderline")
LONG_OUTS = ("alnout", "tabbedout", "chimeras", "nonchimeras")

# verb arguments, outputs, the outputs that stay empty on this workload
# (uchime2/3 classify nothing as borderline; under --mismatch -200 no
# model is perfect, so nothing is a chimera), the scoring kernel whose
# plain version must run (none where every query is in the host round)
CASES = {
    "uchime_denovo": (["--uchime_denovo", "{fa}"], UCHIME_OUTS, (),
                      "score_ranked"),
    "uchime_denovo_crossover0": (["--uchime_denovo", "{small}"],
                                 UCHIME_OUTS, ("borderline",), None),
    "uchime2_denovo": (["--uchime2_denovo", "{fa}"], UCHIME_OUTS,
                       ("borderline",), "score_ranked"),
    "uchime3_denovo": (["--uchime3_denovo", "{fa}"], UCHIME_OUTS,
                       ("borderline",), "score_ranked"),
    "chimeras_denovo": (["--chimeras_denovo", "{fa}"], LONG_OUTS, (),
                        "score_ranked"),
    "chimeras_denovo_long": (["--chimeras_denovo", "{long}"], LONG_OUTS,
                             (), "score_ranked"),
    "uchime_ref": (["--uchime_ref", "{q}", "--db", "{db}"], UCHIME_OUTS, (),
                   "score_dense"),
    "uchime3_denovo_mm200": (["--uchime3_denovo", "{fa}", "--mismatch",
                              "-200"], UCHIME_OUTS,
                             ("uchimealns", "chimeras", "borderline"),
                             "score_ranked"),
}

# the limit in DP cells where it is not 70 000
CELLS_LIMIT = {"uchime_denovo_crossover0": 0}

ROW_WIRE = ("nw_rowscan", "nw_backtrack")
CODES_WIRE = ("nw_wavefront", "nw_backtrack_flat")


@pytest.mark.parametrize("case", sorted(CASES))
def test_chimera_matches_jax(workload, tmp_path, case):
    args, outs, empty, scoring = CASES[case]
    args = [a.format(**workload) for a in args]

    def out_args(side):
        return [x for o in outs for x in ("--" + o, "%s.%s" % (side, o))]

    run_ours(args + out_args("jax"), tmp_path)
    rep = run_port(args + out_args("port") + ["--threads", "1", "--quiet"],
                   tmp_path, setup=SETUP % CELLS_LIMIT.get(case, 70000))
    assert rep["rc"] == 0
    for o in outs:
        jax_out = (tmp_path / ("jax." + o)).read_bytes()
        assert bool(jax_out) != (o in empty), o
        assert jax_out == (tmp_path / ("port." + o)).read_bytes(), o
    # the port's device tier ran (its plain versions, on the CPU device)
    plain = rep["plain_calls"]
    codes = "--mismatch" in args
    wire, other = (CODES_WIRE, ROW_WIRE) if codes else (ROW_WIRE, CODES_WIRE)
    assert all(plain[k] > 0
               for k in ((scoring,) if scoring else ()) + wire), rep
    if scoring == "score_ranked":
        # three device rounds (128, 512 and the rest of the queries, the
        # second resolved with the first's carry): more K4 calls than
        # rounds, so a dispatch took several 512-part chunks
        assert plain[scoring] > 3, rep
    assert not any(plain[k] for k in other), rep
    assert not any(rep["launches"].values())
    loaded = rep["modules"]
    assert "vsearch_tpu_torch.core.chimera" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "vsearch_tpu" or m.startswith("vsearch_tpu.")]


def test_chimera_raises_without_card(monkeypatch, workload, tmp_path):
    """A chimera verb without a card, and without an explicit CPU request,
    raises instead of carrying on on the CPU, and writes no output."""
    import torch
    from vsearch_tpu_torch import cli, device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv(device.ENV, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--uchime3_denovo", str(workload["fa"]), "--nonchimeras",
                  str(tmp_path / "x.fa"), "--quiet"])
    assert not (tmp_path / "x.fa").exists()

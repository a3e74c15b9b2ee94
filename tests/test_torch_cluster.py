"""Greedy clustering end to end: the PyTorch port against the JAX package.

The port runs in a subprocess on its CPU device (every kernel wrapper takes
its plain version) with ClusterEngine.DEVICE_MIN lowered by its driver, so
its device tier -- the growing k-mer index (K4) and the compacted prefetch
(K2 + K3) -- takes over after the first round; its process is shown to
load neither jax nor vsearch_tpu.  The JAX package runs in process.
Outputs must be byte-equal.
"""

import numpy as np
import pytest

from .conftest import run_ours
from .test_torch_search import run_port

# device tier from the 16th centroid on: 800 sequences then run one host
# round of 256 and two device rounds, the second one carrying the first's
# new centroids through the 1-round-lag pipeline
SETUP = ("from vsearch_tpu_torch.core.cluster import ClusterEngine\n"
         "ClusterEngine.DEVICE_MIN = 16")


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """200 random 100 nt ancestors, 4 members each (up to 6 substitutions),
    with abundances: 100 nt (bucket 128) keeps the plain K2's (M, N,
    2048-lane) int32 dirs plane at 0.13 GB."""
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    path = tmp_path_factory.mktemp("families") / "fam.fasta"
    with open(path, "wb") as fh:
        i = 0
        for _ in range(200):
            base = acgt[rng.integers(0, 4, size=100)]
            for m in range(4):
                s = base.copy()
                pos = rng.integers(0, 100, size=rng.integers(0, 7 if m else 1))
                s[pos] = acgt[rng.integers(0, 4, size=pos.size)]
                fh.write(b">s%d;size=%d\n%s\n"
                         % (i, rng.integers(1, 50), s.tobytes()))
                i += 1
    return path


CASES = {
    "fast": (["--cluster_fast", "{fa}", "--id", "0.97"], ()),
    "size_msa": (["--cluster_size", "{fa}", "--id", "0.97"],
                 ("msaout", "consout")),
    "size_both": (["--cluster_size", "{fa}", "--id", "0.9", "--strand",
                   "both"], ()),
    "unoise": (["--cluster_unoise", "{fa}", "--minsize", "1"], ()),
    "smallmem": (["--cluster_smallmem", "{fa}", "--usersort", "--id",
                  "0.97"], ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_matches_jax(families, tmp_path, case):
    args, extra_outs = CASES[case]
    args = [a.format(fa=families) for a in args]
    outs = ("uc", "centroids") + extra_outs

    def out_args(side):
        return [x for o in outs for x in ("--" + o, "%s.%s" % (side, o))]

    run_ours(args + out_args("jax"), tmp_path)
    rep = run_port(args + out_args("port") + ["--threads", "1", "--quiet"],
                   tmp_path, setup=SETUP)
    assert rep["rc"] == 0
    for o in outs:
        jax_out = (tmp_path / ("jax." + o)).read_bytes()
        assert jax_out, o
        assert jax_out == (tmp_path / ("port." + o)).read_bytes(), o
    # the port's device tier ran (its plain versions, on the CPU device)
    assert all(rep["plain_calls"][k] > 0 for k in
               ("score_ranked", "nw_rowscan", "nw_backtrack")), rep
    assert rep["plain_calls"]["score_dense"] == 0
    assert not any(rep["launches"].values())
    loaded = rep["modules"]
    assert "vsearch_tpu_torch.ops.score_grow" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "vsearch_tpu" or m.startswith("vsearch_tpu.")]


def test_cluster_raises_without_card(monkeypatch, families, tmp_path):
    """A cluster verb without a card, and without an explicit CPU request,
    raises instead of carrying on on the CPU."""
    import torch
    from vsearch_tpu_torch import cli, device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv(device.ENV, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--cluster_fast", str(families), "--id", "0.97", "--uc",
                  str(tmp_path / "x.uc"), "--quiet"])
    assert not (tmp_path / "x.uc").exists()

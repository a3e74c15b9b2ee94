"""allpairs_global in the PyTorch port against the JAX package.

K2m, the row-scan forward with the match plane (vsearch_tpu_torch.ops.
nw_rowscan, with_matches=True), is compared cell for cell with the Pallas
kernel (nw_pallas2.build_forward2(..., with_matches=True)) in interpret
mode; K5, the stats walk (vsearch_tpu_torch.ops.allpairs_dev.stats_walk),
with the JAX build_allpairs_stats on the same planes.  Then the whole
command: the port runs in a subprocess on its CPU device, where its device
stats pipeline takes the kernels' plain versions, and its process is shown
to load neither jax nor vsearch_tpu; the JAX package runs in process, where
off the TPU it takes its generic path and aligns every pair.  Every
comparison is exact, and outputs must be byte-equal.
"""

import random
import zlib

import numpy as np
import pytest
import torch

from vsearch_tpu.ops.allpairs_dev import build_allpairs_stats
from vsearch_tpu.ops.nw_pallas2 import build_forward2
from vsearch_tpu_torch.ops import allpairs_dev, cuda_lib, nw_batch, nw_rowscan

from .conftest import run_ours
from .test_allpairs_fast import CASES, pairs_fasta  # noqa: F401 (fixture)
from .test_torch_nw import _pairs, _schemes, _wire
from .test_torch_search import run_port

SCHEMES = ["default", "iupac", "n_mismatch", "overflow"]
M = N = 16
B = 128


def _inputs(case):
    key, alphabet = _schemes()[case]
    qs, ts = _pairs(random.Random(zlib.crc32(case.encode())), B, M, N,
                    alphabet)
    qmT, amT, qlen, t4T, tlen = _wire(key, qs, ts, M, N)
    rqT = np.ascontiguousarray(nw_batch.encode_padded(qs, B, M).T)
    return key, (qmT, amT, rqT, qlen, t4T, tlen)


def _forward(case):
    key, wire = _inputs(case)
    out = nw_rowscan.build_forward(key, with_matches=True)(
        *(torch.from_numpy(a) for a in wire))
    return key, wire, out


@pytest.mark.parametrize("case", SCHEMES)
def test_forward_with_matches_matches_pallas(case):
    import jax.numpy as jnp
    cuda_lib.reset_launches()
    key, (qmT, amT, rqT, qlen, t4T, tlen), (s_t, o_t, d_t, m_t) = \
        _forward(case)
    assert cuda_lib.PLAIN_CALLS["nw_rowscan_mr"] == 1
    assert cuda_lib.PLAIN_CALLS["nw_rowscan"] == 0
    s_j, o_j, d_j, m_j = build_forward2(
        key, M, N, B, interpret=True, with_matches=True)(
        jnp.asarray(qmT), jnp.asarray(amT.astype(np.int8)),
        jnp.asarray(rqT), jnp.asarray(qlen), jnp.asarray(t4T),
        jnp.asarray(tlen))
    assert d_t.dtype == torch.uint16 and m_t.dtype == torch.uint8
    assert tuple(m_t.shape) == (M, N, B)
    assert np.array_equal(np.asarray(s_j), s_t.numpy())
    assert np.array_equal(np.asarray(o_j), o_t.numpy())
    assert np.array_equal(np.asarray(d_j), d_t.numpy())
    assert np.array_equal(np.asarray(m_j), m_t.numpy())
    # the plane counts matches: some cells count several
    assert int(m_t.max()) > 1
    # K2m's score, overflow and dirs are K2's
    for a, b in zip(nw_rowscan.build_forward(key)(
            *(torch.from_numpy(x) for x in (qmT, amT, qlen, t4T, tlen))),
            (s_t, o_t, d_t)):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.uint16
                           else a,
                           b.view(torch.int16) if b.dtype == torch.uint16
                           else b)
    if case == "overflow":
        assert o_t.any() and not o_t.all()


@pytest.mark.parametrize("case", SCHEMES)
def test_stats_walk_matches_jax(case):
    import jax.numpy as jnp
    _, (_, _, _, qlen, _, tlen), (_, _, dirs, mr) = _forward(case)
    qlen_t, tlen_t = torch.from_numpy(qlen), torch.from_numpy(tlen)
    cuda_lib.reset_launches()
    got = allpairs_dev.stats_walk(dirs, mr, qlen_t, tlen_t)
    assert cuda_lib.PLAIN_CALLS["nw_stats"] == 1
    ref = build_allpairs_stats(16, 1, 128)(
        (jnp.asarray(dirs.view(torch.int16).numpy().view(np.uint16)),),
        (jnp.asarray(mr.numpy()),), (jnp.asarray(qlen),),
        (jnp.asarray(tlen),))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 8)
    assert np.array_equal(np.asarray(ref), got.numpy())
    # the walks meet gaps and matches, and end on gaps and on matches
    assert (got[:, 3] > 0).any() and (got[:, 1] > 0).any()
    assert {1, 2, 3} <= set(got[:, 4].tolist())


# the issue's cases plus a mismatch score outside int8, which the JAX
# device wire (int8 am) could not carry and the port's int16 wire does
PORT_CASES = CASES + [
    ("mismatch_m200", ["--id", "0.3", "--mismatch", "-200", "--blast6out",
                       "{o}.b6", "--uc", "{o}.uc"]),
    ("basic_batch96", CASES[0][1]),
]
# the port's process computes on one CPU thread: the suite runs its files
# in parallel workers, where torch's intra-op threads would oversubscribe
# the cores
ONE_THREAD = "import torch\ntorch.set_num_threads(1)\n"
# the same workload in batches of 96 pairs (12 batches and a tail of 24)
BATCH96 = ("from vsearch_tpu_torch.ops.allpairs_dev import AllPairsDevice\n"
           "AllPairsDevice.PAIR_BATCH = 96\n")


@pytest.mark.parametrize("name,opts", PORT_CASES,
                         ids=[c[0] for c in PORT_CASES])
def test_allpairs_matches_jax(pairs_fasta, tmp_path, name,  # noqa: F811
                              opts):
    def expand(tag):
        return [x.replace("{o}", str(tmp_path / tag)) for x in opts]

    base = ["--allpairs_global", str(pairs_fasta), "--minseqlength", "1"]
    run_ours(base + expand("jax"), tmp_path)
    rep = run_port(base + expand("port") + ["--threads", "1", "--quiet"],
                   tmp_path, setup=ONE_THREAD + (
                       BATCH96 if name == "basic_batch96" else ""))
    assert rep["rc"] == 0
    outs = [x for x in opts if x.startswith("{o}")]
    assert outs
    for tpl in outs:
        jax_b = (tmp_path / tpl.replace("{o}", "jax")).read_bytes()
        port_b = (tmp_path / tpl.replace("{o}", "port")).read_bytes()
        if tpl.endswith(".aln"):
            # program banner differs in the first two lines
            jax_b = b"\n".join(jax_b.split(b"\n")[2:])
            port_b = b"\n".join(port_b.split(b"\n")[2:])
        assert port_b == jax_b, "%s: %s differs" % (name, tpl)
    calls = rep["plain_calls"]
    if name == "acceptall":
        # the generic path: every pair through the batched aligner
        assert calls["nw_rowscan_mr"] == 0 and calls["nw_stats"] == 0
    else:
        # the device stats pipeline: one K2m and one K5 call per batch,
        # and with no unaligned gate the whole triangle of 1128 pairs
        assert calls["nw_rowscan_mr"] == calls["nw_stats"] > 0, calls
        if name.startswith("basic"):
            assert calls["nw_rowscan_mr"] == (12 if name == "basic_batch96"
                                              else 1)
    assert not any(rep["launches"].values())
    loaded = rep["modules"]
    assert "vsearch_tpu_torch.commands.allpairs" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "vsearch_tpu" or m.startswith("vsearch_tpu.")]

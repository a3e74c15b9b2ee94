"""The growing k-mer index (ops/score_grow.py) and the compacted prefetch
(ops/nw_batch.compact_gather) of the PyTorch port against the JAX package
on the same seeded inputs.

Every comparison is exact: bit matrices, heap ranks, candidate lists, lane
lists and alignments are integers.  The port runs on its CPU device (the
kernels' plain versions); the JAX package runs its scan kernels on the
CPU.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vsearch_tpu.ops import nw as jax_nw
from vsearch_tpu.ops import score_grow as jax_grow
from vsearch_tpu_torch.ops import cuda_lib, nw_batch
from vsearch_tpu_torch.ops import score_grow as torch_grow
from vsearch_tpu_torch.ops.nw import ScoreScheme
from vsearch_tpu_torch.params import Parameters

CPU = torch.device("cpu")


def _entries(rng, n, w, seqno0=0):
    """n (kmers, length, seqno) entries: unique k-mer lists, lengths with
    ties, seqnos out of insertion order."""
    out = []
    nos = rng.permutation(10 * n)[:n] + seqno0
    for i in range(n):
        kl = np.unique(rng.integers(0, 1 << (2 * w), size=60,
                                    dtype=np.uint32))
        out.append((kl, int(rng.integers(80, 120)), int(nos[i])))
    return out


def _seq(rng, length, alphabet=b"ACGT"):
    return np.frombuffer(alphabet, dtype=np.uint8)[
        rng.integers(0, len(alphabet), size=length)].tobytes()


def _same_state(g_j, g_t):
    assert g_t.n == g_j.n and g_t.words == g_j.words
    assert np.array_equal(np.asarray(g_j.bits),
                          g_t.bits.numpy().view(np.uint32))
    assert np.array_equal(g_j._order, g_t._order)
    assert np.array_equal(g_j._ranks(), g_t._ranks().numpy())


def _host_oracle(entries, queries, k):
    """Per query, the (seqno, count) list of the reference min-heap order
    (count desc, length asc, seqno asc), cut at count >= 1."""
    lens = np.array([e[1] for e in entries])
    nos = np.array([e[2] for e in entries])
    out = []
    for qk in queries:
        counts = np.array([np.intersect1d(qk, e[0]).size for e in entries])
        elig = np.nonzero(counts >= 1)[0]
        order = np.lexsort((nos[elig], lens[elig], -counts[elig]))[:k]
        out.append([(int(nos[elig][i]), int(counts[elig][i]))
                    for i in order])
    return out


def test_growing_index_matches_jax():
    """Two append_rounds, then a build rebuild: the port's bits, heap
    order, ranks, device codes and candidate lists equal the JAX
    package's, and the candidates equal the host lexsort oracle."""
    rng = np.random.default_rng(0)
    w = 6
    entries = _entries(rng, 300, w)
    queries = [np.unique(rng.integers(0, 1 << (2 * w), size=100,
                                      dtype=np.uint32)) for _ in range(20)]
    seqs = {e[2]: _seq(rng, e[1], b"ACGTN") for e in entries}
    g_j = jax_grow.GrowingDeviceKmerIndex(w, capacity=20480)
    g_t = torch_grow.GrowingDeviceKmerIndex(w, capacity=20480, device=CPU)
    assert g_t.bits.shape == (g_j.hashsize + 1, g_j.words)
    for g in (g_j, g_t):
        assert g.append_round(entries[:150])
        g.attach_codes(128, seqs.__getitem__)
        assert g.append_round(entries[150:])
    _same_state(g_j, g_t)
    assert np.array_equal(np.asarray(g_j.codes), g_t.codes.numpy())
    assert np.array_equal(np.asarray(g_j.tlen_dev), g_t.tlen_dev.numpy())

    cuda_lib.reset_launches()
    got = g_t.topk_batch(queries, 9, [1] * len(queries))
    assert cuda_lib.PLAIN_CALLS["score_ranked"] == 1
    assert got == g_j.topk_batch(queries, 9, [1] * len(queries))
    assert got == _host_oracle(entries, queries, 9)

    # rebuild (activation / capacity growth) from the same state
    args = (w, [e[0] for e in entries], [e[1] for e in entries],
            [e[2] for e in entries])
    b_j = jax_grow.GrowingDeviceKmerIndex.build(*args, capacity=20480)
    b_t = torch_grow.GrowingDeviceKmerIndex.build(*args, capacity=20480,
                                                  device=CPU)
    _same_state(b_j, b_t)
    assert b_t.topk_batch(queries, 9, [1] * len(queries)) == got


def test_growing_index_prefix_scan_matches_jax(monkeypatch):
    """Occupancy one past a 4096-position block: the port's top-k scans
    the two filled blocks of its 20480-position capacity (256 of 640
    words) and its candidate lists equal the JAX package's, which scans
    the whole capacity, and the host lexsort oracle."""
    from vsearch_tpu_torch.ops import score_dense
    rng = np.random.default_rng(7)
    w = 6
    entries = _entries(rng, 4097, w)
    queries = [np.unique(rng.integers(0, 1 << (2 * w), size=100,
                                      dtype=np.uint32)) for _ in range(6)]
    g_j = jax_grow.GrowingDeviceKmerIndex(w, capacity=20480)
    g_t = torch_grow.GrowingDeviceKmerIndex(w, capacity=20480, device=CPU)
    for g in (g_j, g_t):
        assert g.append_round(entries[:4096])
        assert g.append_round(entries[4096:])
    _same_state(g_j, g_t)
    assert g_t.words == 640 and g_t.scan_words() == 256
    scanned = []
    ranked_keys = score_dense.ranked_keys

    def spy(Kbits, bits, rank):
        scanned.append((tuple(bits.shape), bits.stride(), rank.numel()))
        return ranked_keys(Kbits, bits, rank)

    monkeypatch.setattr(score_dense, "ranked_keys", spy)
    got = g_t.topk_batch(queries, 12, [1] * len(queries))
    assert scanned == [((g_t.hashsize, 256), (640, 1), 256 * 32)]
    assert got == g_j.topk_batch(queries, 12, [1] * len(queries))
    assert got == _host_oracle(entries, queries, 12)


def test_growing_index_capacity_and_gates():
    """append_round refuses to outgrow the capacity (the engine then
    rebuilds), capacity rounds to whole 4096-position K4 blocks, and
    supports() gates the rank key's count budget."""
    rng = np.random.default_rng(1)
    g = torch_grow.GrowingDeviceKmerIndex(5, capacity=100, device=CPU)
    assert g.cap == 4096 and g.words == 128
    assert g.append_round(_entries(rng, 4000, 5))
    assert not g.append_round(_entries(rng, 97, 5, seqno0=10 ** 6))
    assert g.n == 4000
    assert g.supports([np.zeros(torch_grow.MAX_COUNT, np.uint32)])
    assert not g.supports([np.zeros(torch_grow.MAX_COUNT + 1, np.uint32)])
    with pytest.raises(ValueError):
        torch_grow.GrowingDeviceKmerIndex(5, capacity=1 << 20, device=CPU)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _topk_like(rng, qp, k, n):
    """(vals, idx) rows as a top-k gives them: non-increasing counts (some
    -1 sentinels at the end) and positions, some of them >= n."""
    vals = -np.sort(-rng.integers(-1, 12, size=(qp, k)), axis=1)
    idx = rng.integers(0, n + 5, size=(qp, k))
    idx[vals < 0] = 2 ** 30
    return vals.astype(np.int32), idx.astype(np.int32)


@pytest.mark.parametrize("R", [24, 1024], ids=["truncated", "underfilled"])
def test_compact_lanes_match_jnp_nonzero(R):
    """The port's sync-free lane list equals jnp.nonzero(valid.T.reshape(-1),
    size=R, fill_value=qp*K) (nw_jax.py:607-613), both when more pairs are
    valid than R lanes hold and when the lanes are not filled; it runs no
    nonzero and no host read-back."""
    import jax.numpy as jnp
    rng = np.random.default_rng(R)
    qp, k, K, n = 64, 12, 8, 200
    vals, idx = _topk_like(rng, qp, k, n)
    mm = rng.integers(0, 8, size=qp).astype(np.int32)
    valid = (vals[:, :K] >= mm[:, None]) & (idx[:, :K] < n)
    want = np.asarray(jnp.nonzero(jnp.asarray(valid.T.reshape(-1)), size=R,
                                  fill_value=qp * K)[0])
    assert (valid.sum() > R) == (R == 24)
    with _OpLog() as log:
        got = nw_batch.compact_lanes(torch.from_numpy(vals),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(mm), K, R, n)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # a boolean-mask index reaches nonzero below the dispatcher, so any
    # aten.index call is refused too; .item() and bool() are
    # _local_scalar_dense
    banned = ("nonzero", "_local_scalar_dense", "masked_select",
              "aten.index.")
    assert not [op for op in log.ops if any(b in op for b in banned)], \
        log.ops


def test_compact_gather_matches_scalar_oracle():
    """dispatch_compact on the CPU device: every live lane aligns its
    (query, candidate) pair exactly as the JAX package's scalar oracle
    (vsearch_tpu.ops.nw.align_pair_host), dead lanes carry the 2^30
    position, nsteps counts each lane's ops entries, and the ops wire is
    cut at PREFETCH_OPS_CAP rows."""
    rng = np.random.default_rng(9)
    p = Parameters()
    p.apply_defaults_fixups()
    scheme = ScoreScheme.from_params(p)
    n, width, qp, K, R = 30, 192, 16, 4, 64
    targets = [_seq(rng, int(rng.integers(60, 180))) for _ in range(n)]
    qseqs = []
    for _ in range(qp - 3):          # three padded query rows
        t = bytearray(targets[int(rng.integers(0, n))])
        for _ in range(int(rng.integers(0, 10))):
            t[int(rng.integers(0, len(t)))] = _seq(rng, 1)[0]
        qseqs.append(bytes(t))
    codes = torch.zeros((n + 10, width), dtype=torch.int8)
    tlen = torch.zeros(n + 10, dtype=torch.int32)
    for i, t in enumerate(targets):
        codes[i, :len(t)] = torch.from_numpy(
            nw_batch.encode_padded([t], 1, len(t))[0])
        tlen[i] = len(t)
    vals, idx = _topk_like(rng, qp, 10, n)
    mm = np.full(qp, 2 ** 30, dtype=np.int32)
    mm[:len(qseqs)] = rng.integers(0, 6, size=len(qseqs))
    aligner = nw_batch.BatchAligner(scheme, CPU)
    cuda_lib.reset_launches()
    meta, ops = aligner.dispatch_compact(
        qseqs, qp, torch.from_numpy(vals), torch.from_numpy(idx), mm, K, R,
        codes, tlen, width, n)
    assert cuda_lib.PLAIN_CALLS["nw_rowscan"] == 1
    assert cuda_lib.PLAIN_CALLS["nw_backtrack"] == 1
    meta, ops = meta.numpy(), ops.numpy()
    M = nw_batch._bucket(max(len(s) for s in qseqs))
    assert meta.shape == (5, R)
    assert ops.shape == (min(M + width, nw_batch.PREFETCH_OPS_CAP), R)
    q_idx, pos, score, over, nsteps = meta
    lanes = nw_batch.compact_lanes(torch.from_numpy(vals),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(mm), K, R, n).numpy()
    live = lanes < qp * K
    assert live.sum() > 10 and not live.all()
    assert (pos[~live] == 2 ** 30).all()
    assert np.array_equal(q_idx[live], lanes[live] % qp)
    assert np.array_equal(pos[live], idx[lanes[live] % qp,
                                         lanes[live] // qp])
    jax_scheme = jax_nw.ScoreScheme.from_params(p)
    checked = 0
    for lane in np.nonzero(live)[0]:
        qs, ts = qseqs[q_idx[lane]], targets[pos[lane]]
        ref = jax_nw.align_pair_host(jax_scheme, qs, ts)
        assert not over[lane]
        assert score[lane] == ref.score
        col = ops[:, lane]
        if nsteps[lane] <= ops.shape[0]:
            assert nsteps[lane] == (col != 0).sum()
            res = aligner.assemble_one(int(score[lane]), col, qs, ts)
            assert (res.cigar, res.aligned, res.matches, res.mismatches,
                    res.gaps) == (ref.cigar, ref.aligned, ref.matches,
                                  ref.mismatches, ref.gaps)
            checked += 1
    assert checked > 10

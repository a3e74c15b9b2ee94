"""K-mer scoring of the PyTorch port (vsearch_tpu_torch.ops.score_dense
and ops.score) against the JAX package on the same inputs.

Every comparison is exact: the work is integer counts and a total order.
The JAX side runs its Pallas kernels in interpret mode, its scan kernels
and its DeviceKmerIndex on the CPU; the port runs its kernels' plain
versions.
"""

import numpy as np
import pytest
import torch

from vsearch_tpu import native as jax_native
from vsearch_tpu.ops import score_grow as jax_grow
from vsearch_tpu.ops.score_mxu import (NBLK, WBLK, dense_topk_kernel,
                                       dense_topk_ranked_kernel,
                                       pack_query_bits)
from vsearch_tpu_torch.ops import score_dense
from vsearch_tpu_torch.ops.score import DeviceKmerIndex as TorchIndex

WORDLENGTH = 3
V = 1 << (2 * WORDLENGTH)
WORDS = 640
N_REAL = 100
QP = 128
K = 10


@pytest.fixture(scope="module")
def fixture():
    rng = np.random.default_rng(42)
    bits = np.zeros((V + 1, WORDS), dtype=np.uint32)
    tlists = []
    starts = [0]
    for p in range(N_REAL):
        nk = rng.integers(3, 40)
        tlists.append(np.sort(rng.choice(V, size=nk, replace=False))
                      .astype(np.uint32))
        starts.append(starts[-1] + nk)
    assert jax_native.pack_bits(
        np.ascontiguousarray(np.concatenate(tlists)),
        np.asarray(starts, np.int64), N_REAL, WORDS, bits)
    qlists = []
    for q in range(17):
        nk = rng.integers(1, 50)
        qlists.append(np.sort(rng.choice(V, size=nk, replace=False))
                      .astype(np.uint32))
    return bits, qlists


@pytest.mark.parametrize("packed_keys", [True, False])
def test_dense_topk_matches_pallas(fixture, packed_keys):
    import jax.numpy as jnp
    bits, qlists = fixture
    Kb = pack_query_bits(qlists, QP, V)
    v_j, i_j = dense_topk_kernel(V, WORDS, QP, K, interpret=True,
                                 packed_keys=packed_keys)(
        jnp.asarray(Kb), jnp.asarray(bits[:V]), N_REAL)
    Kb_t = score_dense.pack_query_bits(qlists, QP, V)
    assert np.array_equal(Kb, Kb_t)
    v_t, i_t = score_dense.dense_topk(V, WORDS, QP, K, packed_keys)(
        torch.from_numpy(Kb_t), torch.from_numpy(bits[:V]), N_REAL)
    assert v_t.dtype == torch.int32 and i_t.dtype == torch.int32
    assert np.array_equal(np.asarray(v_j), v_t.numpy())
    assert np.array_equal(np.asarray(i_j), i_t.numpy())


def test_counts_plain_matches_numpy(fixture):
    """The plain counts equal an independent numpy count, and the packed
    keys fold them as count<<17 | (2^17-1-pos), -1 past n_real."""
    bits, qlists = fixture
    Kb = score_dense.pack_query_bits(qlists, QP, V)
    counts = score_dense.counts_or_keys(
        torch.from_numpy(Kb), torch.from_numpy(bits[:V]), N_REAL,
        pack=False).numpy()
    unpacked = np.unpackbits(bits[:V].view(np.uint8), axis=1,
                             bitorder="little").astype(np.int64)
    expect = np.zeros((QP, WORDS * 32), dtype=np.int64)
    for q, kl in enumerate(qlists):
        expect[q] = unpacked[kl.astype(np.int64)].sum(axis=0)
    assert np.array_equal(counts, expect)
    keys = score_dense.counts_or_keys(
        torch.from_numpy(Kb), torch.from_numpy(bits[:V]), N_REAL,
        pack=True).numpy()
    pos = np.arange(WORDS * 32)
    fold = np.where(pos < N_REAL, (expect << 17) | ((1 << 17) - 1 - pos), -1)
    assert np.array_equal(keys, fold)


def _random_db(rng, n, wordlength):
    hashsize = 1 << (2 * wordlength)
    kmer_lists = [np.sort(rng.choice(hashsize, size=int(rng.integers(5, 40)),
                                     replace=False)).astype(np.uint32)
                  for _ in range(n)]
    lengths = rng.integers(80, 90, size=n)
    mapping = np.arange(n)
    return kmer_lists, lengths, mapping


def test_multiblock_index_matches_jax(monkeypatch):
    """A multi-block index, k larger than one block holds: the port's
    DeviceKmerIndex (built itself, and rebuilt from the JAX index's state
    with from_numpy) gives the JAX DeviceKmerIndex's top-k exactly."""
    from vsearch_tpu.ops.score import DeviceKmerIndex as JaxIndex
    monkeypatch.setattr(JaxIndex, "BLOCK_POS", 256)
    monkeypatch.setattr(TorchIndex, "BLOCK_POS", 256)
    rng = np.random.default_rng(5)
    kmer_lists, lengths, mapping = _random_db(rng, 600, WORDLENGTH)
    queries = [np.sort(rng.choice(V, size=int(rng.integers(3, 50)),
                                  replace=False)).astype(np.uint32)
               for _ in range(20)]
    k = 300
    jidx = JaxIndex(WORDLENGTH, kmer_lists, lengths, mapping)
    assert len(jidx.blocks) == 3
    v_j, i_j = jidx.topk(queries, k)

    own = TorchIndex(WORDLENGTH, kmer_lists, lengths, mapping,
                     device=torch.device("cpu"))
    assert len(own.blocks) == 3
    copied = TorchIndex.from_numpy(
        WORDLENGTH,
        [(np.asarray(b), w, base, nr) for b, w, base, nr in jidx.blocks],
        jidx.perm, jidx.seqno_by_pos, jidx.length_by_pos)
    assert np.array_equal(own.seqno_by_pos, jidx.seqno_by_pos)
    for index in (own, copied):
        v_t, i_t = index.topk(queries, k)
        assert v_t.shape == (20, k)
        assert np.array_equal(v_j, v_t)
        assert np.array_equal(i_j, i_t)


def _rank_vector(rng):
    """Heap ranks in position order: the occupied positions in a random
    order, except the last ten, left unranked (RANK_MAX) like the empty
    columns, so the key's mask is exercised on set bits too."""
    rank = np.full(WORDS * 32, score_dense.RANK_MAX, dtype=np.int32)
    rank[:N_REAL - 10] = rng.permutation(N_REAL - 10)
    return rank


def test_ranked_topk_matches_jax(fixture):
    """K4's plain version + torch.topk against the JAX package's dense
    ranked kernel (Pallas, interpret mode; its rank vector permuted into
    the kernel's column order as GrowingDeviceKmerIndex._rank_perm does)
    and its scan kernel (_topk_ranked_kernel, rank in position order)."""
    import jax.numpy as jnp
    bits, qlists = fixture
    rank = _rank_vector(np.random.default_rng(3))
    Kb = pack_query_bits(qlists, QP, V)

    j = np.arange(WORDS * 32)
    r = j % NBLK
    perm = (j // NBLK) * NBLK + 32 * (r % WBLK) + r // WBLK
    v_d, i_d = dense_topk_ranked_kernel(V, WORDS, QP, K, interpret=True)(
        jnp.asarray(Kb), jnp.asarray(bits), jnp.asarray(rank[perm]))

    maxk = 64
    ids = np.zeros((QP, maxk), dtype=np.int32)
    kcounts = np.zeros(QP, dtype=np.int32)
    for q, kl in enumerate(qlists):
        ids[q, :kl.size] = kl
        kcounts[q] = kl.size
    v_s, i_s = jax_grow._topk_ranked_kernel(V, WORDS, QP, maxk, K)(
        jnp.asarray(ids), jnp.asarray(kcounts), jnp.asarray(bits),
        jnp.asarray(rank))

    v_t, i_t = score_dense.dense_topk_ranked(V, WORDS, QP, K)(
        torch.from_numpy(score_dense.pack_query_bits(qlists, QP, V)),
        torch.from_numpy(bits[:V]), torch.from_numpy(rank))
    assert v_t.dtype == torch.int32 and i_t.dtype == torch.int32
    assert (v_t.numpy() >= 0).all()     # 90 ranked positions >= K
    for v_j, i_j in ((v_d, i_d), (v_s, i_s)):
        assert np.array_equal(np.asarray(v_j), v_t.numpy())
        assert np.array_equal(np.asarray(i_j), i_t.numpy())


def test_ranked_keys_plain_matches_numpy(fixture):
    """The plain K4 keys fold independent numpy counts as
    count<<20 | (RANK_MAX - rank), -1 where the rank is RANK_MAX; past the
    ranked positions the top-k carries the -1 / 2^30 sentinels."""
    bits, qlists = fixture
    rank = _rank_vector(np.random.default_rng(4))
    Kb = torch.from_numpy(score_dense.pack_query_bits(qlists, QP, V))
    keys = score_dense.ranked_keys(Kb, torch.from_numpy(bits[:V]),
                                   torch.from_numpy(rank)).numpy()
    unpacked = np.unpackbits(bits[:V].view(np.uint8), axis=1,
                             bitorder="little").astype(np.int64)
    counts = np.zeros((QP, WORDS * 32), dtype=np.int64)
    for q, kl in enumerate(qlists):
        counts[q] = unpacked[kl.astype(np.int64)].sum(axis=0)
    RM = score_dense.RANK_MAX
    assert np.array_equal(keys, np.where(rank < RM, (counts << 20)
                                         | (RM - rank), -1))
    k = N_REAL
    v, i = score_dense.dense_topk_ranked(V, WORDS, QP, k)(
        Kb, torch.from_numpy(bits[:V]), torch.from_numpy(rank))
    assert (v[:, -10:] == -1).all() and (i[:, -10:] == 2 ** 30).all()
    assert (v[:, :-10] >= 0).all()


@pytest.mark.parametrize("used", [1, 37, 128])
def test_column_prefix_matches_full_width(used):
    """ranked_keys and counts_or_keys on a column prefix of a wider bit
    matrix (a strided view, as the growing index scans its filled
    positions) equal the full-width outputs cut to that prefix."""
    rng = np.random.default_rng(used)
    full, qp = 160, 16
    bits = torch.from_numpy(rng.integers(0, 2 ** 32, size=(V + 1, full),
                                         dtype=np.uint32).view(np.int32))
    qlists = [np.sort(rng.choice(V, size=int(rng.integers(0, V)),
                                 replace=False)).astype(np.uint32)
              for _ in range(qp)]
    Kb = torch.from_numpy(score_dense.pack_query_bits(qlists, qp, V)
                          .view(np.int32))
    rank = np.full(full * 32, score_dense.RANK_MAX, dtype=np.int32)
    occ = rng.choice(full * 32, size=full * 16, replace=False)
    rank[occ] = rng.permutation(occ.size)
    rank = torch.from_numpy(rank)
    prefix = bits[:V, :used]
    assert prefix.stride() == (full, 1)
    cut = used * 32
    assert torch.equal(score_dense.ranked_keys(Kb, prefix, rank[:cut]),
                       score_dense.ranked_keys(Kb, bits[:V], rank)[:, :cut])
    for pack in (True, False):
        assert torch.equal(
            score_dense.counts_or_keys(Kb, prefix, cut - 5, pack),
            score_dense.counts_or_keys(Kb, bits[:V], cut - 5, pack)[:, :cut])

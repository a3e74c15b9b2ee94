"""The port's CUDA kernels against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc (the kernels of
vsearch_tpu_torch/csrc build at first use) and skips without one.  The
file imports nothing of jax, so it runs as it is on a machine with a card:

    python -m pytest -q -m cuda tests/test_torch_kernels.py

chip_smoke.py makes the same comparisons at the main path's shapes.  Every
comparison is exact: the work is integer counts and integer DP.
"""

import pathlib
import random

import numpy as np
import pytest
import torch

from vsearch_tpu_torch.ops import (allpairs_dev, cuda_lib, nw_batch,
                                   nw_rowscan, nw_wavefront, score_dense,
                                   score_grow)
from vsearch_tpu_torch.ops.nw import ScoreScheme
from vsearch_tpu_torch.params import Parameters

from .torch_helpers import (ACCEPT_TERMS, accept_options, accept_rows,
                            longest_gap_run)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these "
                    "comparisons on the card")
    return torch.device("cuda")


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Exact equality, also for uint16 (compared through an int16 view)."""
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("wordlength,words,qp", [(2, 130, 5), (5, 700, 96),
                                                 (8, 128, 17)])
def test_score_dense_kernel_matches_plain(cuda_device, wordlength, words, qp):
    rng = np.random.default_rng(wordlength)
    V = 1 << (2 * wordlength)
    bits = rng.integers(0, 2 ** 32, size=(V, words), dtype=np.uint32)
    qlists = [np.sort(rng.choice(V, size=int(rng.integers(0, min(V, 600))),
                                 replace=False)).astype(np.uint32)
              for _ in range(qp)]
    Kb = torch.from_numpy(score_dense.pack_query_bits(qlists, qp, V)
                          .view(np.int32))
    bt = torch.from_numpy(bits.view(np.int32))
    n_real = words * 32 - 7
    for pack in (True, False):
        ref = score_dense.counts_or_keys(Kb, bt, n_real, pack)
        before = cuda_lib.LAUNCHES["score_dense"]
        got = score_dense.counts_or_keys(Kb.to(cuda_device),
                                         bt.to(cuda_device), n_real, pack)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["score_dense"] == before + 1
        assert _same(ref, got)


@pytest.mark.parametrize("wordlength,words,qp", [(2, 130, 5), (5, 700, 96),
                                                 (8, 128, 17)])
def test_score_ranked_kernel_matches_plain(cuda_device, wordlength, words,
                                           qp):
    """K4 on a view of the growing index's (V+1)-row matrix, with a third
    of the positions unranked (empty), against its plain version; then the
    ranked top-k on both devices."""
    rng = np.random.default_rng(wordlength + 10)
    V = 1 << (2 * wordlength)
    bits = rng.integers(0, 2 ** 32, size=(V + 1, words), dtype=np.uint32)
    qlists = [np.sort(rng.choice(V, size=int(rng.integers(0, min(V, 600))),
                                 replace=False)).astype(np.uint32)
              for _ in range(qp)]
    Kb = torch.from_numpy(score_dense.pack_query_bits(qlists, qp, V)
                          .view(np.int32))
    rank = np.full(words * 32, score_dense.RANK_MAX, dtype=np.int32)
    occ = rng.choice(words * 32, size=words * 32 * 2 // 3, replace=False)
    rank[occ] = rng.permutation(occ.size)
    rank_t = torch.from_numpy(rank)
    bt = torch.from_numpy(bits.view(np.int32))
    bt_dev = bt.to(cuda_device)
    ref = score_dense.ranked_keys(Kb, bt[:V], rank_t)
    before = cuda_lib.LAUNCHES["score_ranked"]
    got = score_dense.ranked_keys(Kb.to(cuda_device), bt_dev[:V],
                                  rank_t.to(cuda_device))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["score_ranked"] == before + 1
    assert _same(ref, got)
    assert bool((ref == -1).any())
    fn = score_dense.dense_topk_ranked(V, words, qp, 40)
    for r, g in zip(fn(Kb, bt[:V], rank_t),
                    fn(Kb.to(cuda_device), bt_dev[:V],
                       rank_t.to(cuda_device))):
        assert _same(r, g)


@pytest.mark.parametrize("n_ids", [0, 1, 15, 16, 17, 255, 256, 2047, 2048,
                                   4097])
def test_score_kernels_exact_at_id_counts(cuda_device, n_ids):
    """K1 (both epilogues) and K4 on queries of exactly n_ids k-mers: the
    adder groups' edges (16 +- 1), 2^8, K4's MAX_COUNT, and K1's id windows
    (2048, and more than two windows on the counts-only path).  The bits
    are a 130-word column prefix (off the 128-word tile) of a 200-word
    matrix, with one all-ones and one all-zero column so that a count
    reaches n_ids exactly; qp = 7."""
    rng = np.random.default_rng(n_ids)
    V, words, full, qp = 1 << 16, 130, 200, 7
    bits = rng.integers(0, 2 ** 32, size=(V, full), dtype=np.uint32)
    bits[:, 0] = 0xFFFFFFFF
    bits[:, 129] = 0
    qlists = [np.sort(rng.choice(V, size=n_ids, replace=False))
              .astype(np.uint32) for _ in range(qp)]
    Kb = torch.from_numpy(score_dense.pack_query_bits(qlists, qp, V)
                          .view(np.int32))
    bt = torch.from_numpy(bits.view(np.int32))
    bt_dev = bt.to(cuda_device)
    rank = np.full(words * 32, score_dense.RANK_MAX, dtype=np.int32)
    occ = rng.choice(words * 32, size=words * 16, replace=False)
    rank[occ] = rng.permutation(occ.size)
    rank_t = torch.from_numpy(rank)
    n_real = words * 32 - 3
    for pack in (True, False):
        ref = score_dense.counts_or_keys(Kb, bt[:, :words], n_real, pack)
        got = score_dense.counts_or_keys(Kb.to(cuda_device),
                                         bt_dev[:, :words], n_real, pack)
        assert _same(ref, got)
    assert int(ref.max()) == n_ids
    if n_ids <= score_dense.MAX_COUNT:
        ref = score_dense.ranked_keys(Kb, bt[:, :words], rank_t)
        got = score_dense.ranked_keys(Kb.to(cuda_device), bt_dev[:, :words],
                                      rank_t.to(cuda_device))
        assert _same(ref, got)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 8192])
def test_growing_topk_prefix_cuda_matches_cpu(cuda_device, n):
    """topk_dispatch scans the filled 4096-position blocks only (K4 on a
    column prefix of the index), at n on both sides of a block edge and at
    capacity; the top-k equals the CPU run's."""
    rng = np.random.default_rng(n)
    w = 6
    kmer_lists = [np.unique(rng.integers(0, 1 << (2 * w), size=60,
                                         dtype=np.uint32)) for _ in range(n)]
    lengths = rng.integers(80, 120, size=n).tolist()
    seqnos = rng.permutation(10 * n)[:n].tolist()
    queries = [np.unique(rng.integers(0, 1 << (2 * w), size=100,
                                      dtype=np.uint32)) for _ in range(40)]
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        g = score_grow.GrowingDeviceKmerIndex.build(
            w, kmer_lists, lengths, seqnos, capacity=8192, device=dev)
        assert g.scan_words() == -(-n // 4096) * 128
        before = cuda_lib.LAUNCHES["score_ranked"]
        q, pending = g.topk_dispatch(queries, 30)
        (nq, (vals, idx)), = pending
        assert vals.shape == (40, min(30, n))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert cuda_lib.LAUNCHES["score_ranked"] == before + 1
        out.append((vals.cpu(), idx.cpu()))
    for r, g in zip(*out):
        assert _same(r, g)


def test_growing_index_and_compaction_cuda_match_cpu(cuda_device):
    """The growing index's scatter appends, ranks and K4 top-k, and the
    compacted prefetch (lane list, K2, K3) give the same results on the
    card as on the CPU."""
    rng = np.random.default_rng(21)
    w = 8
    entries = []
    for i in range(900):
        kl = np.unique(rng.integers(0, 1 << (2 * w), size=150,
                                    dtype=np.uint32))
        entries.append((kl, int(rng.integers(140, 160)), int(i)))
    queries = [np.unique(rng.integers(0, 1 << (2 * w), size=150,
                                      dtype=np.uint32)) for _ in range(300)]
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = {e[2]: acgt[rng.integers(0, 4, size=e[1])].tobytes()
            for e in entries}
    qseqs = [seqs[int(i)] for i in rng.integers(0, 900, size=len(queries))]
    p = Parameters()
    p.apply_defaults_fixups()
    scheme = ScoreScheme.from_params(p)
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        g = score_grow.GrowingDeviceKmerIndex(w, capacity=40960, device=dev)
        assert g.append_round(entries[:500])
        g.attach_codes(192, seqs.__getitem__)
        assert g.append_round(entries[500:])
        q, pending = g.topk_dispatch(queries, 20)
        (nq, (vals, idx)), = pending
        mm = np.full(nq, 2, dtype=np.int32)
        meta, ops = nw_batch.BatchAligner(scheme, dev).dispatch_compact(
            qseqs, nq, vals, idx, mm, 8, 2048, g.codes, g.tlen_dev,
            g.codes_width, g.n)
        torch.cuda.synchronize()
        out.append([t.cpu() for t in (g.bits, vals, idx, meta, ops)])
    for r, g in zip(*out):
        assert _same(r, g)


def _default_key(n_mismatch=False, match=None):
    p = Parameters()
    p.apply_defaults_fixups()
    p.opt_n_mismatch = n_mismatch
    s = ScoreScheme.from_params(p)
    key = (s.match, s.mismatch, s.go_q_left, s.go_t_left, s.go_q_int,
           s.go_t_int, s.go_q_right, s.go_t_right, s.ge_q_left, s.ge_t_left,
           s.ge_q_int, s.ge_t_int, s.ge_q_right, s.ge_t_right, s.n_mismatch)
    return key if match is None else (match,) + key[1:]


def _pairs(rng, B, M, N, alphabet):
    qs, ts = [], []
    for _ in range(B):
        q = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, M)))
        if rng.random() < 0.6:
            t = list(q)
            for _ in range(rng.randint(0, 6)):
                t[rng.randrange(len(t))] = rng.choice(alphabet)
            t = "".join(t)[:N]
        else:
            t = "".join(rng.choice(alphabet)
                        for _ in range(rng.randint(1, N)))
        qs.append(q.encode())
        ts.append(t.encode())
    return qs, ts


CASES = {
    "default": (lambda: _default_key(), "ACGT"),
    "iupac": (lambda: _default_key(), "ACGTNRYSWKMBDHV"),
    "n_mismatch": (lambda: _default_key(n_mismatch=True), "ACGTN"),
    "overflow": (lambda: _default_key(match=2500), "ACGT"),
    # identical and near-identical pairs as long as the plane: their
    # diagonal runs pass RLCAP and restart
    "identity": (lambda: _default_key(), "ACGT"),
}


def _identity_pairs(rng, B, M, N):
    qs, ts = [], []
    for _ in range(B):
        q = [rng.choice("ACGT") for _ in range(min(M, N) - rng.randint(0, 40))]
        t = list(q)
        for _ in range(rng.randint(0, 3)):
            t[rng.randrange(len(t))] = rng.choice("ACGT")
        qs.append("".join(q).encode())
        ts.append("".join(t).encode())
    return qs, ts


def _case_pairs(case, B, M, N):
    rng = random.Random(len(case) + M + B)
    if case == "identity":
        return _identity_pairs(rng, B, M, N)
    return _pairs(rng, B, M, N, CASES[case][1])


def _run_wraps(dirs, mr=None) -> int:
    """Cells whose diagonal run restarts after RLCAP (run length 1 after a
    predecessor at RLCAP), in the pair that has most; with mr, the match
    count must restart with it."""
    rl = (dirs.view(torch.int16).to(torch.int32) & 0xFFFF) >> 4
    wrap = (rl[1:, 1:] == 1) & (rl[:-1, :-1] == nw_rowscan.RLCAP)
    if mr is not None:
        m = mr.to(torch.int32)
        assert bool((m[1:, 1:][wrap] <= 1).all())
        assert bool((m[:-1, :-1][wrap] > 1).all())
    return int(wrap.sum(dim=(0, 1)).max())


# (case, M, N, B): the four schemes; sizes off every multiple of 32 and of
# a block's pairs; the search prefetch (640 x 640 x 512), the cluster
# prefetch (512 x 512 x 2048) and a walk round (640 x 640 x 128); runs
# that pass RLCAP twice in 600 nt; then batches off K3's pairs a block
# and a warp (1, 33, 129, 2049) and planes with M != N
ROWSCAN_SHAPES = ([(c, 200, 150, 300) for c in sorted(CASES)
                   if c != "identity"]
                  + [("default", 1, 1, 1), ("default", 33, 47, 17),
                     ("iupac", 33, 47, 17), ("default", 640, 640, 512),
                     ("default", 512, 512, 2048), ("default", 640, 640, 128),
                     ("identity", 640, 640, 64)]
                  + [("default", 120, 130, 1), ("default", 120, 130, 33),
                     ("default", 120, 130, 129), ("default", 200, 150, 2049),
                     ("default", 640, 200, 64), ("default", 200, 640, 64)])


@pytest.mark.parametrize("case,M,N,B", ROWSCAN_SHAPES)
def test_rowscan_and_backtrack_kernels_match_plain(cuda_device, case, M, N,
                                                   B):
    """K2 and K3 against their plain versions, run on the same card."""
    key = CASES[case][0]()
    qs, ts = _case_pairs(case, B, M, N)
    qmT, amT = nw_batch.encode_rowT(qs, B, M, key[1], bool(key[14]))
    t4T = np.ascontiguousarray(nw_batch.encode_padded(ts, B, N).T)
    qlen = np.array([len(q) for q in qs], dtype=np.int32)
    tlen = np.array([len(t) for t in ts], dtype=np.int32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (qmT, amT, qlen, t4T, tlen)]
    cuda_lib.reset_launches()
    got = nw_rowscan.build_forward(key)(*args)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["nw_rowscan"] == 1
    ref = nw_rowscan.forward_plain(
        key, nw_rowscan._scheme(key).score_min(),
        nw_rowscan.overflow_possible(key, M, N), *args)
    for r, g in zip(ref, got):
        assert _same(r, g)
    if case == "overflow":
        assert bool(ref[1].any())
    if case == "identity":
        assert _run_wraps(got[2]) >= 2
    ops_ref = nw_batch.backtrack_rle_plain(ref[2], args[2], args[4])
    ops_got = nw_batch.backtrack_rle(got[2], args[2], args[4])
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["nw_backtrack"] == 1
    assert _same(ops_ref, ops_got)


def _random_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n)).encode()


def _backtrack_case(case, rng):
    """(pairs, M, N, lengths K3 walks or None for the pairs' own) of a
    K3-only case."""
    if case == "reject":
        # random pairs as long as the plane: paths of well over 150 runs
        qs = [_random_seq(rng, rng.randint(450, 512)) for _ in range(64)]
        ts = [_random_seq(rng, rng.randint(450, 512)) for _ in range(64)]
        return qs, ts, 512, 512, None
    if case == "gap_chains":
        # one gap of 1..40 in each pair, a deletion (D moves, up the
        # rows) or an insertion (I moves, along a row), so chains of
        # every length cross a window's edge on either side
        qs, ts = [], []
        for g in range(1, 41):
            q = _random_seq(rng, 260)
            at = rng.randint(40, 200)
            qs += [q, q]
            ts += [q[:at] + q[at + g:], q[:at] + _random_seq(rng, g) + q[at:]]
        return qs, ts, 264, 304, None
    if case == "drains":
        # boundary drains: short queries against long targets and the
        # reverse, and lanes with one length 0 whose whole walk is drains,
        # over 4095 in two of them (the count's cap)
        qs = [_random_seq(rng, 12), _random_seq(rng, 4200), b"A", b"A",
              _random_seq(rng, 300), _random_seq(rng, 9)]
        ts = [_random_seq(rng, 4200), _random_seq(rng, 20), b"C", b"C",
              _random_seq(rng, 280), _random_seq(rng, 4100)]
        lens = ([12, 4200, 0, 4200, 300, 9], [4200, 20, 4200, 0, 280, 0])
        return qs, ts, 4200, 4200, lens
    # len1: one sequence of each pair a single nucleotide
    qs, ts = [], []
    for k in range(32):
        a, b = _random_seq(rng, 1), _random_seq(rng, rng.randint(1, 64))
        qs.append(a if k % 2 else b)
        ts.append(b if k % 2 else a)
    return qs, ts, 64, 64, None


@pytest.mark.parametrize("case", ["reject", "gap_chains", "drains", "len1"])
def test_backtrack_kernel_matches_plain(cuda_device, case):
    """K3 alone against its plain version on planes from K2's plain
    version: paths that need many windows, gap chains crossing a window's
    edge, boundary drains (and the 4095 cap), single-nucleotide pairs."""
    key = _default_key()
    qs, ts, M, N, lens = _backtrack_case(case, random.Random(case))
    B = len(qs)
    qmT, amT = nw_batch.encode_rowT(qs, B, M, key[1], bool(key[14]))
    t4T = np.ascontiguousarray(nw_batch.encode_padded(ts, B, N).T)
    qlen = np.array([len(q) for q in qs], dtype=np.int32)
    tlen = np.array([len(t) for t in ts], dtype=np.int32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (qmT, amT, qlen, t4T, tlen)]
    _, _, dirs = nw_rowscan.forward_plain(
        key, nw_rowscan._scheme(key).score_min(),
        nw_rowscan.overflow_possible(key, M, N), *args)
    if lens is not None:
        args[2], args[4] = (torch.tensor(v, dtype=torch.int32,
                                         device=cuda_device) for v in lens)
    ref = nw_batch.backtrack_rle_plain(dirs, args[2], args[4])
    cuda_lib.reset_launches()
    got = nw_batch.backtrack_rle(dirs, args[2], args[4])
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["nw_backtrack"] == 1
    assert _same(ref, got)
    steps = (ref != 0).sum(dim=0)
    if case == "reject":
        assert int(steps.max()) > 150
    if case == "drains":
        assert int(((ref >> 2) == 4095).sum()) >= 2


@pytest.mark.parametrize("case,M,N,B", [(c, 200, 150, 300) for c in
                                        sorted(CASES) if c != "identity"]
                         + [("default", 400, 400, 4096),
                            ("default", 1, 1, 1), ("default", 33, 47, 17),
                            ("identity", 400, 400, 64)])
def test_rowscan_mr_and_stats_kernels_match_plain(cuda_device, case, M, N,
                                                  B):
    """K2m and K5 against their plain versions; 400 x 400 x 4096 is the
    allpairs cell's batch, and 400 nt identical pairs restart their runs
    and match counts after RLCAP.  The overflow scheme takes K2m's 32-bit
    body, the others its 16-bit body."""
    key = CASES[case][0]()
    qs, ts = _case_pairs(case, B, M, N)
    host = _mr_wire(key, qs, ts, M, N)
    got, ref = _mr_run(cuda_device, key, host, M, N)
    if case == "overflow":
        assert bool(ref[1].any())
    if case == "identity":
        assert _run_wraps(got[2], got[3]) >= 1
        assert int((got[3] == nw_rowscan.RLCAP).sum()) > 0
    qlen_d, tlen_d = host[3].to(cuda_device), host[5].to(cuda_device)
    st_got = allpairs_dev.stats_walk(got[2], got[3], qlen_d, tlen_d)
    st_ref = allpairs_dev.stats_walk_plain(got[2], got[3], qlen_d, tlen_d)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["nw_stats"] == 1
    assert _same(st_ref, st_got)


def _mr_wire(key, qs, ts, M, N, lens=None):
    """K2m's inputs (qmT, amT, rqT, qlen, t4T, tlen) on the CPU; lens, if
    given, replaces the pairs' lengths."""
    B = len(qs)
    qmT, amT = nw_batch.encode_rowT(qs, B, M, key[1], bool(key[14]))
    rqT = np.ascontiguousarray(nw_batch.encode_padded(qs, B, M).T)
    t4T = np.ascontiguousarray(nw_batch.encode_padded(ts, B, N).T)
    qlen = np.array([len(q) for q in qs], dtype=np.int32)
    tlen = np.array([len(t) for t in ts], dtype=np.int32)
    if lens is not None:
        qlen, tlen = (np.array(v, dtype=np.int32) for v in lens)
    return [torch.from_numpy(a) for a in (qmT, amT, rqT, qlen, t4T, tlen)]


def _mr_run(cuda_device, key, host, M, N):
    """K2m on the card, as routed, against its plain version on the same
    card: the route's body launched once and the other body never, every
    output equal bit for bit.  Returns (kernel outputs, plain outputs)."""
    body = ("nw_rowscan_mr16" if nw_rowscan.rowscan16(key, M, N)
            else "nw_rowscan_mr")
    other = ({"nw_rowscan_mr", "nw_rowscan_mr16"} - {body}).pop()
    fwd = nw_rowscan.build_forward(key, with_matches=True)
    cuda_lib.reset_launches()
    got = fwd(*(a.to(cuda_device) for a in host))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[body] == 1
    assert cuda_lib.LAUNCHES[other] == 0
    assert cuda_lib.LAUNCHES["nw_rowscan"] == 0
    ref = nw_rowscan.forward_plain(
        key, nw_rowscan._scheme(key).score_min(),
        nw_rowscan.overflow_possible(key, M, N),
        *(a.to(cuda_device) for a in (host[0], host[1], host[3], host[4],
                                      host[5], host[2])))
    for r, g in zip(ref, got):
        assert _same(r, g)
    return got, ref


def _edge_scheme():
    """A scheme whose 16-bit envelope ends near 600 nt (match 40, mismatch
    -50), and the largest square plane, a multiple of 8, inside it."""
    key = (40, -50) + _default_key()[2:]
    W = 8
    while nw_rowscan.rowscan16(key, W + 8, W + 8):
        W += 8
    return key, W


def _mr16_case(case, B):
    """(key, pairs, M, N, lens) of a 16-bit body edge case."""
    rng = random.Random(case + str(B))
    if case == "cell":
        # the allpairs cell's pairs: random 400 nt
        qs = [_random_seq(rng, 400) for _ in range(B)]
        ts = [_random_seq(rng, 400) for _ in range(B)]
        return _default_key(), qs, ts, 400, 400, None
    if case == "lengths":
        # the two pairs of a couple differ in qlen and tlen; lengths 0, 1,
        # the plane's and past it
        qs = [_random_seq(rng, rng.randint(1, 64)) for _ in range(B)]
        ts = [_random_seq(rng, rng.randint(1, 64)) for _ in range(B)]
        pick = [0, 1, 2, 63, 64, 70]
        lens = ([pick[k % 6] if k % 3 else len(qs[k]) for k in range(B)],
                [pick[(k // 2) % 6] if k % 4 else len(ts[k])
                 for k in range(B)])
        return _default_key(), qs, ts, 64, 64, lens
    if case == "identity":
        qs, ts = _identity_pairs(rng, B, 400, 400)
        return _default_key(), qs, ts, 400, 400, None
    if case == "ambiguous":
        # ambiguous codes in both sequences, N under n_mismatch
        qs, ts = _pairs(rng, B, 200, 150, "ACGTNRYSWKMBDHVN")
        return _default_key(n_mismatch=True), qs, ts, 200, 150, None
    key, W = _edge_scheme()
    if case == "edge_out":
        W += 8
    # identical pairs (the highest scores), all-mismatch pairs and pairs
    # with one long gap (the lowest), random pairs
    qs, ts = [], []
    for k in range(B):
        q = _random_seq(rng, W)
        kind = k % 4
        if kind == 0:
            t = q
        elif kind == 1:
            t = bytes(b"ACGT"[(b"ACGT".index(c) + 1) % 4] for c in q)
        elif kind == 2:
            t = q[:W // 5]
        else:
            t = _random_seq(rng, W)
        qs.append(q)
        ts.append(t)
    return key, qs, ts, W, W, None


@pytest.mark.parametrize("case,B", [("cell", 1), ("cell", 17), ("cell", 33),
                                    ("cell", 4095), ("lengths", 40),
                                    ("lengths", 41), ("identity", 63),
                                    ("ambiguous", 301), ("edge_in", 64),
                                    ("edge_out", 64)])
def test_rowscan_mr16_edges_match_plain(cuda_device, case, B):
    """K2m's 16-bit body (two pairs a warp) at its edges against the plain
    version: batches that leave a lone pair in the last couple (1, 17, 33,
    4095), couples whose pairs differ in length (0, 1, the plane's, past
    it), 400 nt identical pairs whose runs restart after RLCAP in both
    halves, ambiguous codes and N under n_mismatch, and a scheme on each
    side of its envelope's edge (edge_out takes the 32-bit body)."""
    key, qs, ts, M, N, lens = _mr16_case(case, B)
    assert nw_rowscan.rowscan16(key, M, N) == (case != "edge_out")
    got, _ = _mr_run(cuda_device, key, _mr_wire(key, qs, ts, M, N, lens), M,
                     N)
    if case == "identity":
        assert _run_wraps(got[2], got[3]) >= 1
        assert int((got[3] == nw_rowscan.RLCAP).sum()) > 0
        # in pairs of both halves of the couples
        wraps = (got[3] == nw_rowscan.RLCAP).any(dim=0).any(dim=0)
        assert bool(wraps[0::2].any()) and bool(wraps[1::2].any())


def test_rowscan_mr_match_220_takes_the_32_bit_body(cuda_device):
    """--match 220: some pairs overflow the 16-bit forward, so K2m runs its
    32-bit body with overflow tracking, equal to the plain version."""
    key = _default_key(match=220)
    assert not nw_rowscan.rowscan16(key, 200, 200)
    qs, ts = _identity_pairs(random.Random(220), 64, 200, 200)
    qs += [_random_seq(random.Random(k), 180) for k in range(64)]
    ts += [_random_seq(random.Random(k + 64), 190) for k in range(64)]
    _, ref = _mr_run(cuda_device, key, _mr_wire(key, qs, ts, 200, 200),
                     200, 200)
    assert bool(ref[1].any()) and not bool(ref[1].all())


# K5-only cases: K3's four, identical 400 nt pairs (RLCAP wraps, mr at
# 255), the overflow scheme, and random 400 nt pairs as the allpairs cell
# has them at B = 1, 17 and 152 (the cell's tail batch)
STATS_CASES = ["reject", "gap_chains", "drains", "len1", "identity",
               "overflow", "cell_b1", "cell_b17", "cell_b152"]


def _stats_planes(case, device):
    """(dirs, mr, qlen, tlen, overflow) of a K5-only case: the planes from
    K2m's plain version, the lengths K5 walks (past the plane in the drains
    case)."""
    rng = random.Random(case)
    key = _default_key(match=2500 if case == "overflow" else None)
    lens = None
    if case in ("reject", "gap_chains", "drains", "len1"):
        qs, ts, M, N, lens = _backtrack_case(case, rng)
        if case == "drains":
            # and lanes whose lengths run past the plane: their reads
            # clamp to its last row or column
            qs += [_random_seq(rng, 300) for _ in range(3)]
            ts += [_random_seq(rng, 280) for _ in range(3)]
            lens = (lens[0] + [4300, 4250, 4300],
                    lens[1] + [4250, 4210, 100])
    elif case == "identity":
        # 400 nt copies, half of them with up to 3 substitutions
        qs, ts = [], []
        for k in range(32):
            q = _random_seq(rng, 400)
            t = bytearray(q)
            for _ in range(k % 2 * rng.randint(1, 3)):
                t[rng.randrange(400)] = ord(rng.choice("ACGT"))
            qs.append(q)
            ts.append(bytes(t))
        M = N = 400
    elif case == "overflow":
        qs, ts = _pairs(rng, 96, 200, 150, "ACGT")
        M, N = 200, 150
    else:
        B = int(case.split("_b")[1])
        qs = [_random_seq(rng, 400) for _ in range(B)]
        ts = [_random_seq(rng, 400) for _ in range(B)]
        M = N = 400
    B = len(qs)
    qmT, amT = nw_batch.encode_rowT(qs, B, M, key[1], bool(key[14]))
    rqT = np.ascontiguousarray(nw_batch.encode_padded(qs, B, M).T)
    t4T = np.ascontiguousarray(nw_batch.encode_padded(ts, B, N).T)
    qlen = np.array([len(q) for q in qs], dtype=np.int32)
    tlen = np.array([len(t) for t in ts], dtype=np.int32)
    qmT, amT, rqT, qlen, t4T, tlen = (torch.from_numpy(a).to(device) for a in
                                      (qmT, amT, rqT, qlen, t4T, tlen))
    _, over, dirs, mr = nw_rowscan.forward_plain(
        key, nw_rowscan._scheme(key).score_min(),
        nw_rowscan.overflow_possible(key, M, N), qmT, amT, qlen, t4T, tlen,
        rqT)
    if lens is not None:
        qlen, tlen = (torch.tensor(v, dtype=torch.int32, device=device)
                      for v in lens)
    return dirs, mr, qlen, tlen, over


@pytest.mark.parametrize("case", STATS_CASES)
def test_stats_kernel_matches_plain(cuda_device, case):
    """K5 alone against its plain version on planes from K2m's plain
    version: paths that need many windows, gap chains crossing a window's
    edge, boundary drains (the 4095 cap splitting one into two entries of
    one run, lanes of length 0, clamped reads past the plane),
    single-nucleotide pairs, RLCAP-split runs with mr at 255, overflowing
    pairs, and batches off a block's pairs."""
    dirs, mr, qlen, tlen, over = _stats_planes(case, cuda_device)
    ref = allpairs_dev.stats_walk_plain(dirs, mr, qlen, tlen)
    cuda_lib.reset_launches()
    got = allpairs_dev.stats_walk(dirs, mr, qlen, tlen)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["nw_stats"] == 1
    assert _same(ref, got)
    ops = nw_batch.backtrack_rle_plain(dirs, qlen, tlen)
    if case == "reject":
        assert int((ops != 0).sum(dim=0).max()) > 150
    if case == "drains":
        assert int(((ops >> 2) == 4095).sum()) >= 2
    if case == "identity":
        assert _run_wraps(dirs, mr) >= 1
        assert int((mr == nw_rowscan.RLCAP).sum()) > 0
    if case == "overflow":
        assert bool(over.any()) and not bool(over.all())


@pytest.mark.parametrize("mismatch", [-4, -200])
def test_batch_aligner_cuda_matches_cpu(cuda_device, monkeypatch, mismatch):
    """The aligner's device path gives the same results on the card as on
    the CPU (the plain versions): K2 and K3 on the row wire, K6 and K7
    under a mismatch score outside int8."""
    monkeypatch.setattr(nw_batch.BatchAligner, "NATIVE_CELLS_LIMIT", 0)
    p = Parameters()
    p.apply_defaults_fixups()
    p.opt_mismatch = mismatch
    scheme = ScoreScheme.from_params(p)
    rng = random.Random(8)
    qs, ts = _pairs(rng, 150, 300, 280, "ACGTN")
    res = {}
    for dev in ("cpu", cuda_device):
        cuda_lib.reset_launches()
        res[str(dev)] = nw_batch.BatchAligner(scheme, dev).align_pairs(qs, ts)
    row = mismatch == -4
    assert cuda_lib.LAUNCHES["nw_rowscan"] == int(row)
    assert cuda_lib.LAUNCHES["nw_backtrack"] == int(row)
    assert cuda_lib.LAUNCHES["nw_wavefront"] == int(not row)
    assert cuda_lib.LAUNCHES["nw_backtrack_flat"] == int(not row)
    assert res["cpu"] == res[str(cuda_device)]


WAVEFRONT_CASES = {
    "default": (lambda: _default_key(), "ACGT"),
    "mismatch_200": (lambda: _default_key()[:1] + (-200,)
                     + _default_key()[2:], "ACGTNRYSWKMBDHV"),
    "n_mismatch": (lambda: _default_key(n_mismatch=True)[:1] + (-200,)
                   + _default_key(n_mismatch=True)[2:], "ACGTN"),
    "overflow": (lambda: _default_key(match=2500), "ACGT"),
}


@pytest.mark.parametrize("case,M,N,B,edges", [
    (c, 200, 150, 300, False) for c in sorted(WAVEFRONT_CASES)]
    + [("mismatch_200", 1500, 700, 40, False),
       ("default", 640, 640, 512, False)]
    + [("mismatch_200", M, 50, 17, True) for M in (1, 31, 32, 33, 65)]
    + [("n_mismatch", 40, 1, 17, True),
       ("n_mismatch", 40, 3000, 17, True),
       ("mismatch_200", 300, 200, 1, False),
       ("n_mismatch", 300, 200, 17, True),
       ("mismatch_200", 300, 28300, 2, False)])
def test_wavefront_and_flat_backtrack_kernels_match_plain(
        cuda_device, case, M, N, B, edges):
    """K6 and K7 against their plain versions.  Band edges: M of 1, 31,
    32, 33 and 65 rows (one band, a full one, a second of one row, a
    third); N = 1; N = 3000 at M = 40, where the link between the two
    bands' warps wraps its 128-column ring 23 times; 1500 rows over 6
    rounds of the block's 8 warps; B of 1 and 17.
    edges=True sets lanes of qlen 0, tlen 0, qlen = M with tlen = N, qlen
    above M, tlen above N and tlen -2 (left of j = 0 the score still
    follows the plain version).  640 x 640 x 512 is the search prefetch's
    shape; D = 28 499 puts the row passed between the pair's last and
    first warps in a global scratch instead of shared memory."""
    make_key, alphabet = WAVEFRONT_CASES[case]
    key = make_key()
    qs, ts = _pairs(random.Random(len(case) + M), B, M, N, alphabet)
    q4 = nw_batch.encode_padded(qs, B, M)
    t4 = nw_batch.encode_padded(ts, B, N)
    qlen = np.array([len(q) for q in qs], dtype=np.int32)
    tlen = np.array([len(t) for t in ts], dtype=np.int32)
    if edges:
        qlen[:6] = (0, len(qs[1]), M, M + 3, len(qs[4]), len(qs[5]))
        tlen[:6] = (len(ts[0]), 0, N, len(ts[3]), N + 5, -2)
    args = [torch.from_numpy(a).to(cuda_device) for a in (q4, qlen, t4, tlen)]
    cuda_lib.reset_launches()
    got = nw_wavefront.build_forward(key)(*args)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["nw_wavefront"] == 1
    ref = nw_wavefront.forward_plain(
        key, ScoreScheme(*key[:14], bool(key[14])).score_min(), *args)
    for r, g in zip(ref, got):
        assert _same(r, g)
    if case == "overflow":
        assert bool(ref[1].any())
    ops_got = nw_batch.backtrack_flat(got[2], args[1], args[3])
    ops_ref = nw_batch.backtrack_flat_plain(got[2], args[1], args[3])
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["nw_backtrack_flat"] == 1
    assert _same(ops_ref, ops_got)


def _flat_backtrack_case(case, rng):
    """(pairs, M, N, lengths K7 walks or None for the pairs' own) of a
    K7-only case."""
    if case in ("reject", "gap_chains", "len1"):
        return _backtrack_case(case, rng)
    if case == "iupac":
        # ambiguous codes score 0: paths leave M runs through cells with
        # LEFT but not UP set, which end a run of M moves
        qs, ts = _pairs(rng, 64, 300, 300, "ACGTNRYSWKMBDHV")
        return qs, ts, 300, 300, None
    if case == "drains":
        # short queries against long targets and the reverse, and lanes
        # with one length 0 whose whole walk is a drain
        qs = [_random_seq(rng, 12), _random_seq(rng, 600), b"A", b"A",
              _random_seq(rng, 300), _random_seq(rng, 9)]
        ts = [_random_seq(rng, 600), _random_seq(rng, 20), b"C", b"C",
              _random_seq(rng, 280), _random_seq(rng, 500)]
        lens = ([12, 600, 0, 600, 300, 9], [600, 20, 600, 0, 280, 0])
        return qs, ts, 600, 600, lens
    # past_plane: lengths above M (some above the lane stride Ms = 384)
    # and above N, whose first cells lie past the plane's last diagonal or
    # row and are read at the plain version's clamped addresses; walks
    # capped at S = M + N
    qs, ts = [], []
    for _ in range(8):
        q = _random_seq(rng, 300)
        qs.append(q)
        ts.append(q[:140] + _random_seq(rng, 140))
    lens = ([303, 400, 4300, 310, 5, 300, 150, 299],
            [285, 290, 4210, 50, 400, 280, 600, 279])
    return qs, ts, 300, 280, lens


# K7-only cases: K3's reject, gap_chains and len1 pairs, drains with
# lanes of length 0, lengths past the plane, IUPAC pairs, and a plane of
# lane stride M (not a multiple of 16) at an odd address, which K7 reads
# a byte a cell
FLAT_CASES = ["reject", "gap_chains", "drains", "len1", "past_plane",
              "iupac", "unaligned"]


@pytest.mark.parametrize("case", FLAT_CASES)
def test_flat_backtrack_kernel_matches_plain(cuda_device, case):
    """K7 alone against its plain version on planes from K6's plain
    version under --mismatch -200: paths that need many windows, gap
    chains crossing a window's edge on either side, drains, single-
    nucleotide pairs, clamped reads past the plane, and a plane that
    takes no 16-byte loads."""
    key = _default_key()
    key = key[:1] + (-200,) + key[2:]
    qs, ts, M, N, lens = _flat_backtrack_case(
        "gap_chains" if case == "unaligned" else case, random.Random(case))
    B = len(qs)
    q4 = nw_batch.encode_padded(qs, B, M)
    t4 = nw_batch.encode_padded(ts, B, N)
    qlen = np.array([len(q) for q in qs], dtype=np.int32)
    tlen = np.array([len(t) for t in ts], dtype=np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (q4, qlen, t4, tlen)]
    _, _, dirs = nw_wavefront.forward_plain(
        key, ScoreScheme(*key[:14], bool(key[14])).score_min(), *args)
    qlen, tlen = args[1], args[3]
    if lens is not None:
        qlen, tlen = (torch.tensor(v, dtype=torch.int32, device=cuda_device)
                      for v in lens)
    ref = nw_batch.backtrack_flat_plain(dirs, qlen, tlen)
    if case == "unaligned":
        D = dirs.shape[0]
        buf = torch.empty(D * B * M + 1, dtype=torch.uint8,
                          device=cuda_device)
        packed = buf[1:].view(D, B, M)
        packed.copy_(dirs[:, :, :M])
        assert packed.data_ptr() % 16 and M % 16
        dirs = packed
        assert _same(ref, nw_batch.backtrack_flat_plain(dirs, qlen, tlen))
    cuda_lib.reset_launches()
    got = nw_batch.backtrack_flat(dirs, qlen, tlen)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["nw_backtrack_flat"] == 1
    assert _same(ref, got)
    moves = (ref != 0).sum(dim=0)
    if case == "reject":
        assert int(moves.max()) > 300
    if case == "gap_chains":
        # a run of one gap op longer than the 32 diagonals K7 walks in a
        # window before it fetches the next
        assert longest_gap_run(ref) > 32
    if case == "drains":
        assert int(moves[2]) == 600 and int(moves[3]) == 600
    if case == "past_plane":
        # a walk cut at S
        assert bool((ref[-1] != 0).any())
    if case == "iupac":
        assert _left_ends_run(dirs, ref, qlen, tlen)


def _left_ends_run(dirs, ops, qlen, tlen) -> bool:
    """Does some path take I after an M (or at its start) at a cell with
    LEFT but not UP set?"""
    d, o = dirs.cpu(), ops.cpu().tolist()
    D, _, Ms = d.shape
    for b, (i, j) in enumerate(zip(qlen.tolist(), tlen.tolist())):
        i, j, prev = i - 1, j - 1, 1
        for t in range(len(o)):
            op = o[t][b]
            if op == 0 or i < 0 or j < 0:
                break
            w = int(d[min(i + j, D - 1), b, min(i, Ms - 1)])
            if prev == 1 and w & 3 == 2:
                return True
            i, j, prev = i - (op != 3), j - (op != 2), op
    return False


@pytest.mark.parametrize("iddef,n", [(d, 4096) for d in range(5)]
                         + [(2, 2048 * 2047 // 2)],
                         ids=["iddef%d" % d for d in range(5)] + ["cell"])
def test_accept_mask_and_fetch_cuda_match_cpu(cuda_device, iddef, n):
    """The allpairs accept cascade on the card gives the CPU's mask, every
    term on and each term alone, at the thresholds and zero denominators
    of accept_rows and over the cell's whole triangle; queue_rows and
    take_rows on the card (two bytes a pair copied to pinned memory) give
    the CPU's accepted and overflow indices, in the same ascending
    order."""
    from vsearch_tpu_torch.commands.allpairs import accept_mask
    stats, qlen, tlen = accept_rows(3100 + iddef, n)
    cpu = [torch.from_numpy(a) for a in (stats, qlen, tlen)]
    card = [t.to(cuda_device) for t in cpu]
    sets = [ACCEPT_TERMS] + [{k: v} for k, v in ACCEPT_TERMS.items()]
    for opts in sets:
        eff = accept_options(Parameters, iddef, **opts)
        want = accept_mask(eff, *cpu)
        got = accept_mask(eff, *card)
        assert got.device.type == "cuda" and got.dtype == torch.bool
        assert torch.equal(got.cpu(), want), opts
    over = torch.from_numpy(np.random.default_rng(iddef).random(len(stats))
                            < 0.005)
    ok = want & ~over
    want_rows = allpairs_dev.take_rows(allpairs_dev.queue_rows(ok, over))
    handle = allpairs_dev.queue_rows(ok.to(cuda_device),
                                     over.to(cuda_device))
    host, event, lo = handle
    assert host.is_pinned() and host.dtype == torch.bool and lo == 0
    assert host.numel() == 2 * len(ok) and event is not None
    got_rows = allpairs_dev.take_rows(handle)
    for w, g in zip(want_rows, got_rows):
        assert g.dtype == np.int64 and np.array_equal(g, w)
        assert w.size > 0 and (np.diff(w) > 0).all()
    assert np.array_equal(want_rows[0], np.flatnonzero(ok.numpy()))
    assert np.array_equal(want_rows[1], np.flatnonzero(over.numpy()))


def test_allpairs_chunks_cuda_match_cpu(cuda_device, tmp_path, monkeypatch):
    """A triangle of 400 nt sequences in 8 chunks of 2 batches of 128 on
    the card: every output byte-equal to the CPU's run, and each chunk's
    realign on the device route (K2), queued on the triangle's stream."""
    from benchmark.gen import seqgen
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.utils import phasetimer
    AllPairsDevice = allpairs_dev.AllPairsDevice
    monkeypatch.setattr(AllPairsDevice, "PAIR_BATCH", 128)
    monkeypatch.setattr(AllPairsDevice, "CHUNK_BATCHES", 2)
    monkeypatch.setattr(phasetimer, "ENABLED", True)
    # 56 related sequences (7 clades of 8, every pair within 90 %) and 8
    # random ones, in a random order: about three pairs in four accepted
    rng = seqgen.rng_for(2016, 3, 0)
    related, _ = seqgen.taxon_tree(rng, [7, 8], [4, 2], [1, 0], 400)
    codes = np.concatenate([related, seqgen.uniform(rng, 8, 400)])
    codes = codes[rng.permutation(len(codes))]
    fa = tmp_path / "set.fa"
    seqgen.write_fasta(fa, "s", codes)
    calls = []
    begin = nw_batch.BatchAligner.align_pairs_begin

    def counted(self, qseqs, tseqs):
        before = cuda_lib.LAUNCHES["nw_rowscan"]
        out = begin(self, qseqs, tseqs)
        calls.append((len(qseqs), cuda_lib.LAUNCHES["nw_rowscan"] - before,
                      torch.cuda.current_stream()
                      == torch.cuda.default_stream()))
        return out

    monkeypatch.setattr(nw_batch.BatchAligner, "align_pairs_begin", counted)
    outs = {}
    for run in ("cuda", "cpu"):
        cuda_lib.reset_launches()
        phasetimer.reset()
        calls.clear()
        files = [str(tmp_path / ("%s.%s" % (run, ext)))
                 for ext in ("b6", "uc", "user")]
        assert cli.main(["--allpairs_global", str(fa), "--id", "0.9",
                         "--blast6out", files[0], "--uc", files[1],
                         "--userout", files[2], "--userfields",
                         "query+target+id+raw+caln", "--threads", "1",
                         "--quiet"], device=run) == 0
        outs[run] = [pathlib.Path(f).read_bytes() for f in files]
        if run == "cpu":
            continue
        tally = dict(phasetimer.tally)
        assert tally["allpairs.batches"] == 16, tally
        assert tally["allpairs.chunks"] == 8, tally
        assert cuda_lib.LAUNCHES["nw_rowscan_mr16"] == 16
        assert cuda_lib.LAUNCHES["nw_stats"] == 16
        assert not any(cuda_lib.PLAIN_CALLS.values())
        # a realign a chunk, each on the card, on the triangle's stream
        assert len(calls) == 8, calls
        assert all(n > 0 and k2 > 0 and main
                   for n, k2, main in calls), calls
        assert 1000 < tally["allpairs.accepted"] < 2016 - 8 * 56
    for want, got in zip(outs["cpu"], outs["cuda"]):
        assert got == want
    assert outs["cuda"][0].count(b"\n") > 1000


def test_allpairs_full_length_batch_matches_batches_of_32(cuda_device):
    """Full-length 16S pairs (W = 1456) in one batch of 4096, as the card's
    memory sizes it: the planes hold 1456 x 1456 x 4096 = 8.68e9 cells,
    past 2**31, so K2m's and K5's plane offsets must not wrap.  The same
    pairs in batches of 32, whose planes stay under 2**31, give the same
    overflow flags and stats for every pair, and the first 32 match the
    plain versions on the CPU."""
    rng = np.random.default_rng(1456)
    base = rng.integers(0, 4, 1480)
    seqs = []
    for k in range(92):
        s = base.copy()
        pos = rng.choice(s.size, size=int(rng.integers(0, 40)),
                         replace=False)
        s[pos] = rng.integers(0, 4, pos.size)
        for _ in range(int(rng.integers(0, 4))):
            at = int(rng.integers(0, s.size))
            s = np.delete(s, np.arange(at, at + int(rng.integers(1, 4))))
        seqs.append(bytes(np.frombuffer(b"ACGT", np.uint8)[
            s[:1450 - (k % 7) * 8]]))
    key = _default_key()
    scheme = ScoreScheme(*key[:14], bool(key[14]))
    dev = allpairs_dev.AllPairsDevice(scheme, seqs, cuda_device)
    assert dev.W == 1456 and dev.batch == 4096
    assert nw_rowscan.rowscan16(key, 1456, 1456)
    q, t = np.triu_indices(len(seqs), 1)
    qpos = torch.from_numpy(q[:4096]).to(cuda_device)
    tpos = torch.from_numpy(t[:4096]).to(cuda_device)
    assert 1456 * 1456 * len(qpos) > 2 ** 31
    cuda_lib.reset_launches()
    over, stats = (x.cpu() for x in dev.run(qpos, tpos))
    assert cuda_lib.LAUNCHES["nw_rowscan_mr16"] == 1
    dev.batch = 32
    over32, stats32 = (x.cpu() for x in dev.run(qpos, tpos))
    assert cuda_lib.LAUNCHES["nw_rowscan_mr16"] == 1 + 4096 // 32
    assert not bool(over.any())
    assert torch.equal(over, over32) and torch.equal(stats, stats32)
    # related pairs: long matched runs, a few gaps
    assert int(stats[:, 1].min()) > 1300 and int(stats[:, 2].max()) > 0
    plain = allpairs_dev.AllPairsDevice(scheme, seqs, torch.device("cpu"))
    over_p, stats_p = plain.run(qpos[:32].cpu(), tpos[:32].cpu())
    assert torch.equal(over_p, over[:32]) and torch.equal(stats_p,
                                                          stats[:32])

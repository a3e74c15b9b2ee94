"""Alignment of the PyTorch port (vsearch_tpu_torch.ops.nw_rowscan and
ops.nw_batch) against the JAX package on the same inputs.

The forward is compared with the Pallas row-scan kernel
(nw_pallas2.build_forward2) in interpret mode, cell for cell: score,
overflow flag and the whole uint16 direction/run-length plane.  The
run-length backtrack's plain version (K3's) walks that Pallas plane, and
its op | count << 2 entries, expanded into single moves, are compared
with the JAX package's own row-layout walk of the same plane.  The batched
aligner, forced through the port's device path (plain versions on the
CPU), is compared with the scalar oracle align_pair_host.  Every
comparison is exact.
"""

import random

import numpy as np
import pytest
import torch

from vsearch_tpu.ops import nw as jax_nw
from vsearch_tpu.ops import nw_jax
from vsearch_tpu.ops.nw_pallas2 import build_forward2
from vsearch_tpu.params import Parameters
from vsearch_tpu_torch.ops import cuda_lib, nw_batch, nw_rowscan
from vsearch_tpu_torch.ops.nw import ScoreScheme


def _key(s):
    return (s.match, s.mismatch, s.go_q_left, s.go_t_left, s.go_q_int,
            s.go_t_int, s.go_q_right, s.go_t_right, s.ge_q_left,
            s.ge_t_left, s.ge_q_int, s.ge_t_int, s.ge_q_right, s.ge_t_right,
            s.n_mismatch)


def _default_key():
    p = Parameters()
    p.apply_defaults_fixups()
    return _key(jax_nw.ScoreScheme.from_params(p))


def _schemes():
    base = _default_key()
    nmm = base[:14] + (True,)
    # a match score large enough for 16 matches to pass SHRT_MAX: the
    # 16-bit overflow tracking is on
    big = (2500,) + base[1:]
    return {"default": (base, "ACGT"), "iupac": (base, "ACGTNRYSWKMBDHV"),
            "n_mismatch": (nmm, "ACGTN"), "overflow": (big, "ACGT")}


def _pairs(rng, B, M, N, alphabet):
    qs, ts = [], []
    for _ in range(B):
        q = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, M)))
        if rng.random() < 0.6:
            t = list(q)
            for _ in range(rng.randint(0, 4)):
                t[rng.randrange(len(t))] = rng.choice(alphabet)
            t = "".join(t)[:N]
        else:
            t = "".join(rng.choice(alphabet)
                        for _ in range(rng.randint(1, N)))
        qs.append(q.encode())
        ts.append(t.encode())
    return qs, ts


def _wire(key, qs, ts, M, N):
    qmT, amT = nw_batch.encode_rowT(qs, len(qs), M, key[1], bool(key[14]))
    t4T = np.ascontiguousarray(nw_batch.encode_padded(ts, len(ts), N).T)
    qlen = np.array([len(q) for q in qs], dtype=np.int32)
    tlen = np.array([len(t) for t in ts], dtype=np.int32)
    return qmT, amT, qlen, t4T, tlen


@pytest.mark.parametrize("case", ["default", "iupac", "n_mismatch",
                                  "overflow"])
def test_forward_matches_pallas(case):
    import jax.numpy as jnp
    key, alphabet = _schemes()[case]
    M = N = 16
    B = 128
    rng = random.Random(hash(case) % 1000)
    qs, ts = _pairs(rng, B, M, N, alphabet)
    qmT, amT, qlen, t4T, tlen = _wire(key, qs, ts, M, N)
    assert nw_rowscan.overflow_possible(key, M, N) == (case == "overflow")
    s_j, o_j, d_j = build_forward2(key, M, N, B, interpret=True)(
        jnp.asarray(qmT), jnp.asarray(amT.astype(np.int8)),
        jnp.asarray(qlen), jnp.asarray(t4T), jnp.asarray(tlen))
    s_t, o_t, d_t = nw_rowscan.build_forward(key)(
        *(torch.from_numpy(a) for a in (qmT, amT, qlen, t4T, tlen)))
    assert d_t.dtype == torch.uint16 and tuple(d_t.shape) == (M, N, B)
    assert np.array_equal(np.asarray(s_j), s_t.numpy())
    assert np.array_equal(np.asarray(o_j), o_t.numpy())
    assert np.array_equal(np.asarray(d_j), d_t.numpy())
    if case == "overflow":
        assert o_t.any() and not o_t.all()



def _expand_moves(ops: np.ndarray, steps: int) -> np.ndarray:
    """(S, B) op | count << 2 entries -> (steps, B) single moves, 0 after
    the walk."""
    out = np.zeros((steps, ops.shape[1]), dtype=np.int16)
    for b in range(ops.shape[1]):
        col = [int(v) for v in ops[:, b] if v]
        moves = [v & 3 for v in col for _ in range(v >> 2)]
        out[:len(moves), b] = moves
    return out


def _backtrack_pairs(case, rng, M, N):
    """128 seeded pairs: family pairs with substitutions and indels beside
    random ones; for "identity", identical and near-identical pairs as
    long as the plane, whose diagonal runs pass RLCAP."""
    alphabet = "ACGTNRYSWKM" if case == "iupac" else "ACGT"
    pairs = []
    for k in range(128):
        if case == "identity":
            q = random_seq(rng, rng.randint(M - 8, M))
            t = bytearray(q)
            edit = k % 4
            pos = rng.randrange(len(t))
            if edit == 1:
                t[pos] = ord(rng.choice(alphabet))
            elif edit == 2:
                del t[pos:pos + rng.randint(1, 20)]
            elif edit == 3:
                t[pos:pos] = random_seq(rng, rng.randint(1, 20))
            pairs.append((q, bytes(t[:N]) or b"A"))
        elif rng.random() < 0.6:
            q = random_seq(rng, rng.randint(1, M), alphabet)
            pairs.append((q, mutate(rng, q)[:N]))
        else:
            pairs.append((random_seq(rng, rng.randint(1, M), alphabet),
                          random_seq(rng, rng.randint(1, N), alphabet)))
    return pairs


@pytest.mark.parametrize("case", ["mixed", "identity", "iupac"])
def test_backtrack_plain_matches_jax_row_walk(one_thread, case):
    """K3's plain version on the Pallas forward's plane against the JAX
    package's flat walk of the same plane (nw_jax.backtrack with
    row_layout=True, the XLA twin _build_kernels returns for Bp=-1): the
    run-length entries, expanded, are the same moves."""
    import jax
    import jax.numpy as jnp
    key = _default_key()
    M = N = 264
    rng = random.Random({"mixed": 21, "identity": 22, "iupac": 23}[case])
    pairs = _backtrack_pairs(case, rng, M, N)
    qmT, amT, qlen, t4T, tlen = _wire(key, [q for q, _ in pairs],
                                      [t for _, t in pairs], M, N)
    _, _, d_j = build_forward2(key, M, N, len(pairs), interpret=True)(
        jnp.asarray(qmT), jnp.asarray(amT.astype(np.int8)),
        jnp.asarray(qlen), jnp.asarray(t4T), jnp.asarray(tlen))
    bt = nw_jax._build_kernels(key, M, N, Bp=-1)[1]
    moves = np.asarray(jax.jit(bt.__wrapped__,
                               static_argnames="row_layout")(
        d_j, jnp.asarray(qlen), jnp.asarray(tlen), row_layout=True))
    dirs = torch.from_numpy(np.array(d_j).view(np.int16)).view(torch.uint16)
    cuda_lib.reset_launches()
    ops = nw_batch.backtrack_rle(dirs, torch.from_numpy(qlen),
                                 torch.from_numpy(tlen)).numpy()
    assert cuda_lib.PLAIN_CALLS["nw_backtrack"] == 1
    assert ops.shape == (M + N, len(pairs))
    assert np.array_equal(_expand_moves(ops, moves.shape[0]), moves)
    runs = (ops >> 2)[(ops & 3) == nw_batch.OP_M]
    assert runs.max() <= nw_rowscan.RLCAP
    if case == "identity":
        # the identical pairs' runs reach RLCAP and restart
        assert (runs == nw_rowscan.RLCAP).sum() >= 16

def mutate(rng, seq):
    t = bytearray(seq)
    for _ in range(rng.randint(0, 12)):
        if not t:
            break
        op = rng.random()
        pos = rng.randrange(len(t))
        if op < 0.5:
            t[pos] = ord(rng.choice("ACGT"))
        elif op < 0.75:
            del t[pos]
        else:
            t.insert(pos, ord(rng.choice("ACGT")))
    return bytes(t) or b"A"


def random_seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(alphabet) for _ in range(n)).encode()


def _pairs_like_test_nw(case):
    rng = random.Random({"seed1": 1, "seed2": 2, "seed3": 3,
                         "ambiguous": 7, "n_mismatch": 11,
                         "long_identity": 13}[case])
    pairs = []
    if case == "long_identity":
        # diagonal runs past RLCAP (255): the run length restarts on each
        # path, with a substitution or an indel in some; at most 384 nt,
        # one length bucket, keeps the plain forward's planes small
        for n, edits in ((384, 0), (380, 2), (350, 1), (300, 0), (330, 1)):
            q = random_seq(rng, n)
            t = bytearray(q)
            for _ in range(edits):
                t[rng.randrange(n)] = ord(rng.choice("ACGT"))
            pairs.append((q, bytes(t)))
        q = random_seq(rng, 370)
        pairs.append((q, q[:180] + q[181:]))
        return pairs
    if case in ("ambiguous", "n_mismatch"):
        for _ in range(8):
            pairs.append((random_seq(rng, rng.randint(5, 60), "ACGTNRYSWKM"),
                          random_seq(rng, rng.randint(5, 60), "ACGTNRYSWKM")))
        return pairs
    for _ in range(16):
        q = random_seq(rng, rng.randint(1, 120))
        t = mutate(rng, q) if rng.random() < 0.6 else \
            random_seq(rng, rng.randint(1, 120))
        pairs.append((q, t))
    return pairs


@pytest.fixture
def one_thread():
    """One intra-op thread for the plain versions' many small tensor ops:
    beside other test processes on the same cores, a thread team per op
    turns seconds into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["seed1", "seed2", "seed3", "ambiguous",
                                  "n_mismatch", "long_identity"])
def test_align_pairs_matches_oracle(monkeypatch, one_thread, case):
    p = Parameters()
    p.apply_defaults_fixups()
    p.opt_n_mismatch = case == "n_mismatch"
    jax_scheme = jax_nw.ScoreScheme.from_params(p)
    scheme = ScoreScheme(*_key(jax_scheme))
    ba = nw_batch.BatchAligner(scheme, torch.device("cpu"))
    # every batch through the device path, none to the host C tier
    monkeypatch.setattr(nw_batch.BatchAligner, "NATIVE_CELLS_LIMIT", 0)
    pairs = _pairs_like_test_nw(case)
    cuda_lib.reset_launches()
    got = ba.align_pairs([q for q, _ in pairs], [t for _, t in pairs])
    assert cuda_lib.PLAIN_CALLS["nw_rowscan"] == 1
    assert cuda_lib.PLAIN_CALLS["nw_backtrack"] == 1
    for (q, t), r in zip(pairs, got):
        h = jax_nw.align_pair_host(jax_scheme, q, t)
        assert (h.score, h.cigar, h.aligned, h.matches, h.mismatches,
                h.gaps) == (r.score, r.cigar, r.aligned, r.matches,
                            r.mismatches, r.gaps), (q, t)
    if case == "long_identity":
        # the first pair is identical: on its diagonal the run length and
        # the match count reach RLCAP at (254, 254) and restart at 1
        q = pairs[0][0]
        n = len(q)
        qmT, amT, qlen, t4T, tlen = _wire(_key(jax_scheme), [q], [q], n, n)
        rqT = np.ascontiguousarray(nw_batch.encode_padded([q], 1, n).T)
        _, _, dirs, mr = nw_rowscan.build_forward(
            _key(jax_scheme), with_matches=True)(
            *(torch.from_numpy(a) for a in (qmT, amT, rqT, qlen, t4T, tlen)))
        diag = torch.arange(n)
        rl = (dirs.view(torch.int16).to(torch.int32) >> 4)[diag, diag, 0]
        m = mr.to(torch.int32)[diag, diag, 0]
        wrap = nw_rowscan.RLCAP
        assert rl[wrap - 1] == m[wrap - 1] == wrap
        assert rl[wrap] == m[wrap] == 1
        assert rl[-1] == m[-1] == n - wrap



@pytest.mark.parametrize("below", [0, 1], ids=["at_limit", "above_limit"])
def test_route_follows_the_batch_cells(monkeypatch, one_thread, below):
    """A batch of exactly NATIVE_CELLS_LIMIT DP cells runs on the host C
    tier; under a limit one cell lower it runs on the device (its plain
    versions here).  It takes that route on every call, and each result
    equals the scalar oracle's."""
    p = Parameters()
    p.apply_defaults_fixups()
    jax_scheme = jax_nw.ScoreScheme.from_params(p)
    ba = nw_batch.BatchAligner(ScoreScheme(*_key(jax_scheme)),
                               torch.device("cpu"))
    pairs = _pairs_like_test_nw("seed1")
    cells = sum(len(q) * len(t) for q, t in pairs)
    monkeypatch.setattr(nw_batch.BatchAligner, "NATIVE_CELLS_LIMIT",
                        cells - below)
    want = [jax_nw.align_pair_host(jax_scheme, q, t) for q, t in pairs]
    for _ in range(2):
        cuda_lib.reset_launches()
        got = ba.align_pairs([q for q, _ in pairs], [t for _, t in pairs])
        assert cuda_lib.PLAIN_CALLS["nw_rowscan"] == below
        assert cuda_lib.PLAIN_CALLS["nw_backtrack"] == below
        for (q, t), h, r in zip(pairs, want, got):
            assert (h.score, h.cigar, h.aligned, h.matches, h.mismatches,
                    h.gaps) == (r.score, r.cigar, r.aligned, r.matches,
                                r.mismatches, r.gaps), (q, t)

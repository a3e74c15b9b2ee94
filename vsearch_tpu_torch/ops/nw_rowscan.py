"""Row-scan Needleman-Wunsch forward (kernels K2 and K2m).

Counterpart of vsearch_tpu/ops/nw_pallas2.py: K2 with_matches=False, K2m
with_matches=True (the same forward, which also writes the uint8 match
plane of the allpairs stats pipeline, ops/allpairs_dev.py).  One
step per query row; within a row the horizontal gap state E is the
max-plus prefix

    E(j) = max(E0, P(j-1) - (QR - R)) - j*R,   P = cummax(htemp2 + j*R)

and F, H and the diagonal run length are row carries.  Each cell emits a
uint16: bits 0-3 the direction flags (DIR_UP, DIR_LEFT, DIR_EXTUP,
DIR_EXTLEFT, each set by a strict '>'), bits 4-15 the diagonal run length
(restarting after RLCAP).  Layout (M, N, B): cell (i, j) of pair b at
dirs[i, j, b].  The score is read at (qlen-1, tlen-1); overflow is tracked
only when overflow_possible says the reference's 16-bit engine could
overflow for this scheme and geometry.

CUDA tensors launch csrc/nw_rowscan.cu (nw_rowscan_kernel<false> for K2,
<true> for K2m): one warp a pair, its lanes on the rows of a 32-row band,
up to 32 pairs a block writing the planes through a shared stage, and a
(B, N) int4 scratch for each band's last row.  K2m takes its 16-bit body
(nw_rowscan_mr16_kernel: two pairs a warp in 16-bit halves) wherever
rowscan16 holds, a predicate of the scheme and the shape alone.  CPU
tensors take the plain version below, a Python loop over rows vectorised
over (N, B), for either body.  Unlike the TPU kernel, both take any M, N
and B, and the amT wire is int16 so any mismatch score fits.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .nw import (DIR_EXTLEFT, DIR_EXTUP, DIR_LEFT, DIR_UP, SHRT_MAX,
                 ScoreScheme)

NEG = -(2 ** 30)
# Diagonal-run cap in the uint16 dir wire (bits 4..15 hold the run length)
RLCAP = 255

_argtypes_set = False


def _lib():
    global _argtypes_set
    lib = cuda_lib.load("nw_rowscan")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nw_rowscan_launch.argtypes = [p, p, p, p, p, i, i, i, p,
                                          p, p, p, p, p]
        lib.nw_rowscan_launch.restype = i
        lib.nw_rowscan_mr_launch.argtypes = [p, p, p, p, p, p, i, i, i, p,
                                             p, p, p, p, p, p]
        lib.nw_rowscan_mr_launch.restype = i
        lib.nw_rowscan_mr16_launch.argtypes = [p, p, p, p, p, p, i, i, i,
                                               p, p, p, p, p, p, p]
        lib.nw_rowscan_mr16_launch.restype = i
        _argtypes_set = True
    return lib


def _scheme(scheme_key: tuple) -> ScoreScheme:
    return ScoreScheme(*scheme_key[:14], bool(scheme_key[14]))


def _path_bounds(scheme_key: tuple, M: int, N: int):
    """(hlo, hhi): every path score to a cell of the M x N box lies in
    [hlo, hhi], and so does every boundary value; None where a gap scores
    a reward.  hhi = min(M, N) * vmax: at most min(M, N) diagonal cells,
    gaps cost >= 0 and the boundaries are <= 0.  hlo = min(M, N) * vmin -
    2 * max(go) - max(M, N) * max(ge), the score of the specific
    diagonal-then-single-gap path."""
    (match, mismatch, go_q_l, go_t_l, go_q_i, go_t_i, go_q_r, go_t_r,
     ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r, ge_t_r, _) = scheme_key
    gos = (go_q_l, go_t_l, go_q_i, go_t_i, go_q_r, go_t_r)
    ges = (ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r, ge_t_r)
    if min(gos) < 0 or min(ges) < 0:
        return None
    hlo = min(M, N) * min(match, mismatch, 0) - 2 * max(gos) \
        - max(M, N) * max(ges)
    return hlo, min(M, N) * max(match, mismatch, 0)


def overflow_possible(scheme_key: tuple, M: int, N: int) -> bool:
    """Static envelope: can any cell's h reach the reference's 16-bit
    overflow thresholds for this scheme/geometry?

    h(i,j) is the optimal prefix-alignment score, inside _path_bounds.
    When both bounds stay inside (score_min, SHRT_MAX), neither engine can
    flag overflow and the tracking is dropped (reference: align_simd.cpp
    compute_score_min :1432-1444)."""
    bounds = _path_bounds(scheme_key, M, N)
    if bounds is None:
        return True  # gap rewards: bail to exact tracking
    hmin_b, hmax_b = bounds
    score_min = _scheme(scheme_key).score_min()
    return not (hmin_b > score_min + 8 and hmax_b < SHRT_MAX - 8)


def fits_int16(scheme_key: tuple, M: int, N: int) -> bool:
    """Static envelope of the 16-bit body: does every value the forward
    computes in the M x N box -- H, E, F, htemp, htemp2 and the
    intermediates E - R, F - R, h - QR and htemp2 - QR, boundaries
    included, past qlen and tlen too -- lie in [-32768, 32767]?

    h, htemp2, htemp, E and F are path scores or boundaries, so at most
    hhi of _path_bounds; h >= hlo, htemp and htemp2 >= hlo + vmin, F >=
    hlo - max(QR), E >= hlo + vmin - max(QR), and each intermediate
    subtracts at most one more max(ge)."""
    bounds = _path_bounds(scheme_key, M, N)
    if bounds is None:
        return False
    hlo, hhi = bounds
    match, mismatch = scheme_key[:2]
    gos, ges = scheme_key[2:8], scheme_key[8:14]
    max_qr = max(go + ge for go, ge in zip(gos, ges))
    vmin = min(match, mismatch, 0)
    return hlo + vmin - max_qr - max(ges) >= -32768 and hhi <= 32767


def rowscan16(scheme_key: tuple, M: int, N: int) -> bool:
    """K2m's route to its 16-bit body: no overflow tracking, the 16-bit
    envelope, and substitution scores in [-64, 63] (the body's V table
    holds V + 64 in seven bits).  The scheme and the shape alone decide."""
    match, mismatch = scheme_key[0], scheme_key[1]
    return (not overflow_possible(scheme_key, M, N)
            and fits_int16(scheme_key, M, N)
            and -64 <= min(match, mismatch) and max(match, mismatch) <= 63)


def build_forward(scheme_key: tuple, with_matches: bool = False):
    """Forward DP for a scoring scheme (the 15-tuple scheme key).

    Returns forward(qmT (M, B) int8, amT (M, B) int16, qlen (B,) int32,
    t4T (N, B) int8, tlen (B,) int32) -> (score (B,) int32, overflow (B,)
    bool, dirs (M, N, B) uint16), in the encode_rowT wire of
    ops/nw_batch.py: kernel K2.

    with_matches=True gives K2m, the forward of the allpairs stats
    pipeline: forward(qmT, amT, rqT, qlen, t4T, tlen, out=None) takes the
    raw 4-bit query codes rqT (M, B) int8 as well and also returns mr
    (M, N, B) uint8, the IUPAC match count within each cell's diagonal run
    chunk (nw_pallas2.py:256-269).  ``out`` may give the (dirs, mr) planes
    to write, contiguous, so that a caller reuses them across batches."""
    key = tuple(int(v) for v in scheme_key)

    if with_matches:
        def forward_mr(qmT, amT, rqT, qlen, t4T, tlen, out=None):
            return _forward(key, qmT, amT, qlen, t4T, tlen, rqT, out)
        return forward_mr

    def forward(qmT, amT, qlen, t4T, tlen):
        return _forward(key, qmT, amT, qlen, t4T, tlen)

    return forward


def _forward(key: tuple, qmT, amT, qlen, t4T, tlen, rqT=None, out=None,
             _body=None):
    """The forward on either device.  _body names K2m's body,
    "nw_rowscan_mr" or "nw_rowscan_mr16", instead of the route; it is for
    comparing the two on the same inputs."""
    M, B = qmT.shape
    N = t4T.shape[0]
    checks = [("qmT", qmT, torch.int8, (M, B)),
              ("amT", amT, torch.int16, (M, B)),
              ("qlen", qlen, torch.int32, (B,)),
              ("t4T", t4T, torch.int8, (N, B)),
              ("tlen", tlen, torch.int32, (B,))]
    if rqT is not None:
        checks.append(("rqT", rqT, torch.int8, (M, B)))
    if out is not None:
        checks += [("dirs", out[0], torch.uint16, (M, N, B)),
                   ("mr", out[1], torch.uint8, (M, N, B))]
    for name, t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError("%s must be %s %s, got %s %s"
                             % (name, dt, shape, t.dtype, tuple(t.shape)))
        if t.device != qmT.device:
            raise ValueError("%s lies on %s, not %s"
                             % (name, t.device, qmT.device))
    if out is not None and not all(t.is_contiguous() for t in out):
        raise ValueError("the out planes must be contiguous")
    kernel = "nw_rowscan" if rqT is None else "nw_rowscan_mr"
    score_min = _scheme(key).score_min()
    track = overflow_possible(key, M, N)
    if qmT.device.type == "cpu":
        # one plain version serves both of K2m's bodies
        cuda_lib.PLAIN_CALLS[kernel] += 1
        return forward_plain(key, score_min, track, qmT, amT, qlen, t4T,
                             tlen, rqT, out)
    qmT, amT, qlen, t4T, tlen = (x.contiguous() for x in
                                 (qmT, amT, qlen, t4T, tlen))
    dev = qmT.device
    score = torch.empty(B, dtype=torch.int32, device=dev)
    over = torch.empty(B, dtype=torch.bool, device=dev)
    params = (ctypes.c_int * 17)(*key, int(track), score_min)
    stream = cuda_lib.stream_ptr(dev)
    # each band's last row (H, F, run length | match count | target code),
    # 16 bytes a column of a pair; the kernels need no initial value
    if rqT is None:
        rows = torch.empty((B, N, 4), dtype=torch.int32, device=dev)
        dirs = torch.empty((M, N, B), dtype=torch.uint16, device=dev)
        rc = _lib().nw_rowscan_launch(
            qmT.data_ptr(), amT.data_ptr(), qlen.data_ptr(),
            t4T.data_ptr(), tlen.data_ptr(), M, N, B, params,
            score.data_ptr(), over.data_ptr(), dirs.data_ptr(),
            rows.data_ptr(), stream)
        cuda_lib.check(rc, kernel)
        cuda_lib.LAUNCHES[kernel] += 1
        return score, over, dirs
    rqT = rqT.contiguous()
    if out is None:
        out = (torch.empty((M, N, B), dtype=torch.uint16, device=dev),
               torch.empty((M, N, B), dtype=torch.uint8, device=dev))
    dirs, mr = out
    if _body is None:
        _body = "nw_rowscan_mr16" if rowscan16(key, M, N) else kernel
    if _body == "nw_rowscan_mr16":
        if not rowscan16(key, M, N):
            raise ValueError("the 16-bit body cannot take this scheme at "
                             "%d x %d" % (M, N))
        kernel = _body
        # each band's last row of a couple (H, F, run length | match
        # count, two pairs in 16-bit halves), 32 columns of padding
        rows = torch.empty(((B + 1) // 2, N + 32, 4), dtype=torch.int32,
                           device=dev)
        launch = _lib().nw_rowscan_mr16_launch
    elif _body == "nw_rowscan_mr":
        rows = torch.empty((B, N, 4), dtype=torch.int32, device=dev)
        launch = _lib().nw_rowscan_mr_launch
    else:
        raise ValueError("no K2m body %r" % (_body,))
    rc = launch(
        qmT.data_ptr(), amT.data_ptr(), rqT.data_ptr(), qlen.data_ptr(),
        t4T.data_ptr(), tlen.data_ptr(), M, N, B, params,
        score.data_ptr(), over.data_ptr(), dirs.data_ptr(), mr.data_ptr(),
        rows.data_ptr(), stream)
    cuda_lib.check(rc, kernel)
    cuda_lib.LAUNCHES[kernel] += 1
    return score, over, dirs, mr


def forward_plain(key: tuple, score_min: int, track: bool, qmT, amT, qlen,
                  t4T, tlen, rqT=None, out=None):
    """Plain version of K2 (and, given rqT, of K2m): a loop over query
    rows, vectorised over (N, B), with E from torch.cummax
    (nw_pallas2.py:191-224) and the match plane as nw_pallas2.py:256-269
    computes it.  The planes are built in their wire dtypes (in ``out``
    when it is given)."""
    (match, mismatch, go_q_l, go_t_l, go_q_i, go_t_i, go_q_r, go_t_r,
     ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r, ge_t_r, n_mismatch) = key
    QR_q_i = go_q_i + ge_q_i
    QR_q_r = go_q_r + ge_q_r
    QR_t_i = go_t_i + ge_t_i
    QR_t_r = go_t_r + ge_t_r
    M, B = qmT.shape
    N = t4T.shape[0]
    dev = qmT.device
    i32 = torch.int32

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=dev)

    qm_all = qmT.to(i32)
    am_all = amT.to(i32)
    t4c = t4T.to(i32)
    qlen_v = qlen.to(i32)[None, :]
    tlen_v = tlen.to(i32)[None, :]
    jidx = torch.arange(N, dtype=i32, device=dev)[:, None]    # (N, 1)
    amb_t = ~((t4c == 1) | (t4c == 2) | (t4c == 4) | (t4c == 8))
    t_is_n = t4c == 15
    if n_mismatch:
        amb_t = amb_t & ~t_is_n
    right_t = jidx == (tlen_v - 1)                            # (N, B)
    QR_t_v = torch.where(right_t, QR_t_r, QR_t_i).to(i32)
    R_t_v = torch.where(right_t, ge_t_r, ge_t_i).to(i32)
    H = (-(go_q_l + (jidx + 1) * ge_q_l)).expand(N, B).to(i32)
    F = H - QR_t_v
    RL = full((N, B), 0)
    MR = full((N, B), 0)
    score = full((B,), 0)
    hmin = full((B,), 0)
    hmax = full((B,), 0)
    if out is None:
        dirs = torch.empty((M, N, B), dtype=torch.int16, device=dev)
        mr = (torch.empty((M, N, B), dtype=torch.uint8, device=dev)
              if rqT is not None else None)
    else:
        # every cell fits 12 bits, so the int16 view holds it exactly and
        # avoids arithmetic on uint16, which CUDA builds of torch lack
        dirs, mr = out[0].view(torch.int16), out[1]
    rq_all = rqT.to(i32) if rqT is not None else None
    zero_row = full((1, B), 0)
    neg_row = full((1, B), NEG)
    for i in range(M):
        qm = qm_all[i][None, :]
        V = torch.where(t4c == qm, match, am_all[i][None, :]).to(i32)
        V = torch.where(amb_t, 0, V)
        if n_mismatch:
            V = torch.where(t_is_n | (qm == -2), mismatch, V)
        lastq = qlen_v == (i + 1)                             # (1, B)
        QR_q = torch.where(lastq, QR_q_r, QR_q_i).to(i32)
        R_q = torch.where(lastq, ge_q_r, ge_q_i).to(i32)
        diag_left = 0 if i == 0 else -(go_t_l + i * ge_t_l)
        diag = torch.cat((zero_row + diag_left, H[:N - 1]), dim=0)
        htemp = diag + V
        dup = F > htemp
        htemp2 = torch.maximum(htemp, F)
        E0 = -(go_t_l + (i + 1) * ge_t_l) - QR_q
        jR = jidx * R_q
        P = torch.cummax(htemp2 + jR, dim=0).values
        Ps = torch.cat((neg_row, P[:N - 1]), dim=0)
        E = torch.maximum(Ps - (QR_q - R_q), E0) - jR
        dleft = E > htemp2
        h = torch.maximum(E, htemp2)
        dextl = (E - R_q) > (h - QR_q)
        Fx = F - R_t_v
        HF = h - QR_t_v
        dextu = Fx > HF
        F = torch.maximum(Fx, HF)
        leftup = dup | dleft
        RLs = torch.cat((zero_row, RL[:N - 1]), dim=0)
        RL = torch.where(leftup, 0,
                         torch.where(RLs >= RLCAP, 1, RLs + 1)).to(i32)
        dirs[i] = (dup.to(i32) * DIR_UP | dleft.to(i32) * DIR_LEFT
                   | dextu.to(i32) * DIR_EXTUP | dextl.to(i32) * DIR_EXTLEFT
                   | (RL << 4)).to(torch.int16)
        if rq_all is not None:
            rq = rq_all[i][None, :]
            is_m = (rq & t4c) != 0
            if n_mismatch:
                is_m = is_m & ~(t_is_n | (rq == 15))
            is_m = is_m.to(i32)
            MRs = torch.cat((zero_row, MR[:N - 1]), dim=0)
            MR = torch.where(leftup, 0,
                             torch.where(RLs >= RLCAP, is_m,
                                         MRs + is_m)).to(i32)
            mr[i] = MR.to(torch.uint8)
        score = score + torch.where(right_t & lastq, h, 0).sum(
            dim=0, dtype=i32)
        if track:
            hv = torch.where((jidx < tlen_v) & (qlen_v > i), h, 0)
            hmin = torch.minimum(hmin, hv.min(dim=0).values)
            hmax = torch.maximum(hmax, hv.max(dim=0).values)
        H = h
    if track:
        over = (hmin <= score_min) | (hmax >= SHRT_MAX)
    else:
        over = torch.zeros(B, dtype=torch.bool, device=dev)
    dirs = dirs.view(torch.uint16)
    if rq_all is None:
        return score, over, dirs
    return score, over, dirs, mr

"""Anti-diagonal wavefront Needleman-Wunsch forward (kernel K6).

Counterpart of vsearch_tpu/ops/nw_pallas.py (renamed: the port has no
Pallas), the forward the JAX package takes when the row-scan kernel's
preconditions fail (nw_jax.py:388-409); in the port, a scoring scheme whose
mismatch score lies outside int8 (ops/nw_batch.BatchAligner picks the
wire).  Every cell of an anti-diagonal d = i + j depends only on the two
diagonals before it, and the plane is laid out by diagonal.  Same cell
semantics as ops/nw.py's oracle and the row-scan forward (K2); the
direction plane is diagonal-major and holds the four direction bits only,
with no run length, so its backtrack (nw_batch.backtrack_flat, K7) takes
one move a step.

CUDA tensors launch csrc/nw_wavefront.cu: several warps a pair over 32-row
bands, each step of a band one 32-byte run of a diagonal of the plane.
CPU tensors take the plain version below, one vectorised diagonal over all
(B, M) lanes per step, as the JAX package's XLA scan steps it
(nw_jax.py:184-259).  Both take any lengths: a qlen above M, a tlen above
N or a length of 0 or less gives what the XLA scan gives.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .nw import (DIR_EXTLEFT, DIR_EXTUP, DIR_LEFT, DIR_UP, SHRT_MAX,
                 ScoreScheme)

_argtypes_set = False


def _lib():
    global _argtypes_set
    lib = cuda_lib.load("nw_wavefront")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nw_wavefront_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p,
                                            p, p, p]
        lib.nw_wavefront_launch.restype = i
        lib.nw_wavefront_scratch_bytes.argtypes = [i, i, i]
        lib.nw_wavefront_scratch_bytes.restype = ctypes.c_longlong
        _argtypes_set = True
    return lib


def lane_stride(M: int) -> int:
    """Lane stride Ms of the dirs plane: M rounded up to 128, as the TPU
    kernel pads its lanes (nw_pallas.py:52)."""
    return (M + 127) // 128 * 128


def build_forward(scheme_key: tuple):
    """Forward DP for a scoring scheme (the 15-tuple scheme key).

    Returns forward(q4 (B, M) int8, qlen (B,) int32, t4 (B, N) int8, tlen
    (B,) int32) -> (score (B,) int32, overflow (B,) bool, dirs (D, B, Ms)
    uint8), D = M + N - 1, Ms = lane_stride(M), cell (i, j) of pair b at
    dirs[i + j, b, i] and every lane at or past M zero: kernel K6."""
    key = tuple(int(v) for v in scheme_key)

    def forward(q4, qlen, t4, tlen):
        return _forward(key, q4, qlen, t4, tlen)

    return forward


def _forward(key: tuple, q4, qlen, t4, tlen):
    B, M = q4.shape
    N = t4.shape[1]
    if M < 1 or N < 1:
        raise ValueError("the wavefront needs M, N >= 1, got %d, %d"
                         % (M, N))
    for name, t, dt, shape in (("q4", q4, torch.int8, (B, M)),
                               ("qlen", qlen, torch.int32, (B,)),
                               ("t4", t4, torch.int8, (B, N)),
                               ("tlen", tlen, torch.int32, (B,))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError("%s must be %s %s, got %s %s"
                             % (name, dt, shape, t.dtype, tuple(t.shape)))
        if t.device != q4.device:
            raise ValueError("%s lies on %s, not %s"
                             % (name, t.device, q4.device))
    score_min = ScoreScheme(*key[:14], bool(key[14])).score_min()
    if q4.device.type == "cpu":
        cuda_lib.PLAIN_CALLS["nw_wavefront"] += 1
        return forward_plain(key, score_min, q4, qlen, t4, tlen)
    q4, qlen, t4, tlen = (x.contiguous() for x in (q4, qlen, t4, tlen))
    dev = q4.device
    Ms = lane_stride(M)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    over = torch.empty(B, dtype=torch.bool, device=dev)
    dirs = torch.empty((M + N - 1, B, Ms), dtype=torch.uint8, device=dev)
    lib = _lib()
    # the band row passed from a pair's last warp to its first lives in
    # shared memory unless D is too long for it (about 28 000)
    nbytes = lib.nw_wavefront_scratch_bytes(M, N, B)
    if nbytes < 0:
        raise RuntimeError("nw_wavefront: CUDA error sizing the launch")
    wrap = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
            if nbytes else None)
    params = (ctypes.c_int * 16)(*key, score_min)
    rc = lib.nw_wavefront_launch(
        q4.data_ptr(), qlen.data_ptr(), t4.data_ptr(), tlen.data_ptr(),
        M, N, B, Ms, params, score.data_ptr(), over.data_ptr(),
        dirs.data_ptr(), None if wrap is None else wrap.data_ptr(),
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(rc, "nw_wavefront")
    cuda_lib.LAUNCHES["nw_wavefront"] += 1
    return score, over, dirs


def forward_plain(key: tuple, score_min: int, q4, qlen, t4, tlen):
    """Plain version of K6: the XLA scan's step (nw_jax.py:184-259), one
    diagonal over all (B, M) lanes at a time, into a plane of K6's
    layout."""
    (match, mismatch, go_q_l, go_t_l, go_q_i, go_t_i, go_q_r, go_t_r,
     ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r, ge_t_r, n_mismatch) = key
    QR_q_i = go_q_i + ge_q_i
    QR_q_r = go_q_r + ge_q_r
    QR_t_i = go_t_i + ge_t_i
    QR_t_r = go_t_r + ge_t_r
    B, M = q4.shape
    N = t4.shape[1]
    D = M + N - 1
    dev = q4.device
    i32 = torch.int32

    def amb(c):
        return ~((c == 1) | (c == 2) | (c == 4) | (c == 8))

    qc = q4.to(i32)
    amb_q = amb(qc)
    qlen_c = qlen.to(i32)[:, None]
    tlen_c = tlen.to(i32)[:, None]
    ii = torch.arange(M, dtype=i32, device=dev)[None, :]     # (1, M)
    first_i = ii == 0
    last_q = ii == (qlen_c - 1)                                # (B, M)
    QR_q = torch.where(last_q, QR_q_r, QR_q_i).to(i32)
    R_q = torch.where(last_q, ge_q_r, ge_q_i).to(i32)
    valid_i = ii < qlen_c
    left_col = -(go_t_l + (ii + 1) * ge_t_l)
    diag_left = -(go_t_l + ii * ge_t_l)
    # target codes with M zero columns on either side, so that lane i of
    # diagonal d reads column d - i + M (code 0 outside [0, N))
    t_ext = torch.zeros((B, N + 2 * M), dtype=i32, device=dev)
    t_ext[:, M:M + N] = t4.to(i32)
    zeros = torch.zeros((B, M), dtype=i32, device=dev)
    H1, H2, E, F = zeros, zeros, zeros, zeros
    score = torch.zeros(B, dtype=i32, device=dev)
    hmin = torch.zeros(B, dtype=i32, device=dev)
    hmax = torch.zeros(B, dtype=i32, device=dev)
    dirs = torch.zeros((D, B, lane_stride(M)), dtype=torch.uint8,
                       device=dev)
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    for d in range(D):
        jb = d - ii                                            # (1, M)
        tj = t_ext[:, d + M - torch.arange(M, device=dev)]     # (B, M)
        if n_mismatch:
            V = torch.where((qc == 15) | (tj == 15), mismatch,
                            torch.where(amb_q | amb(tj), 0,
                                        torch.where(qc == tj, match,
                                                    mismatch)))
        else:
            V = torch.where(amb_q | amb(tj), 0,
                            torch.where(qc == tj, match, mismatch))
        V = V.to(i32)
        valid = (jb >= 0) & (jb < tlen_c) & valid_i
        right_t = jb == (tlen_c - 1)
        QR_t = torch.where(right_t, QR_t_r, QR_t_i).to(i32)
        R_t = torch.where(right_t, ge_t_r, ge_t_i).to(i32)
        top_hm1 = -(go_q_l + (jb + 1) * ge_q_l)
        diag_top = torch.where(jb == 0, 0, -(go_q_l + jb * ge_q_l))
        H2s = torch.cat((zero_col, H2[:, :M - 1]), dim=1)       # H2[i-1]
        F_ps = torch.cat((zero_col, F[:, :M - 1]), dim=1)       # F[i-1]
        diag_in = torch.where(first_i, diag_top,
                              torch.where(jb == 0, diag_left, H2s))
        E_in = torch.where(jb == 0, left_col - QR_q, E)
        F_in = torch.where(first_i, top_hm1 - QR_t, F_ps)
        h = diag_in + V
        d_up = F_in > h
        h = torch.maximum(h, F_in)
        d_left = E_in > h
        h = torch.maximum(h, E_in)
        hv = torch.where(valid, h, 0)
        hmin = torch.minimum(hmin, hv.min(dim=1).values)
        hmax = torch.maximum(hmax, hv.max(dim=1).values)
        HF = h - QR_t
        Fx = F_in - R_t
        d_extup = Fx > HF
        F = torch.maximum(Fx, HF)
        HE = h - QR_q
        Ex = E_in - R_q
        d_extleft = Ex > HE
        E = torch.maximum(Ex, HE)
        H2, H1 = H1, h
        bits = (d_up.to(i32) * DIR_UP | d_left.to(i32) * DIR_LEFT
                | d_extup.to(i32) * DIR_EXTUP
                | d_extleft.to(i32) * DIR_EXTLEFT)
        dirs[d, :, :M] = torch.where(valid, bits, 0).to(torch.uint8)
        at_end = (d == (qlen_c + tlen_c - 2)) & last_q
        score = score + torch.where(at_end, h, 0).sum(dim=1, dtype=i32)
    over = (hmin <= score_min) | (hmax >= SHRT_MAX)
    return score, over, dirs

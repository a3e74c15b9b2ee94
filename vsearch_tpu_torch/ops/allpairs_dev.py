"""Device pipeline for all-vs-all global alignment (allpairs_global).

Counterpart of vsearch_tpu/ops/allpairs_dev.py, a redesign of reference
src/commands/allpairs_global.cpp:340-520: the sequence codes go to the
device once, the triangular pair schedule runs through it as index-pair
batches, and each batch runs the row-scan forward with the match plane
(K2m, ops/nw_rowscan.py) and then the stats walk (K5, csrc/nw_stats.cu) on
the same stream.  Only 8 int32 of stats and an overflow flag per pair reach
the host, in one copy at the end of the triangle; acceptance then runs
vectorised on the host and only the accepted pairs are aligned again for
their CIGARs (commands/allpairs.py).

The stats come out of the run-length walk itself: the forward records, per
cell, the diagonal run length and the IUPAC match count within that exact
run chunk, so the walk accumulates aligned/matches/indels/gap-opens and the
first and last run (op, length) without reading the sequences.  Their
semantics are backtrack16's counting (align_simd.cpp:1132-1235), the
--n_mismatch N rule included; the first and last runs feed align_trim
(searchcore.cpp:343-464) on the host.

CUDA tensors launch the kernels; CPU tensors take their plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from . import cuda_lib
from .nw import DIR_EXTLEFT, DIR_EXTUP, DIR_LEFT, DIR_UP
from .nw_batch import OP_D, OP_I, OP_M, OP_NONE, encode_padded
from .nw_rowscan import build_forward
from ..utils.phasetimer import add, phase

# stats columns (the JAX package's order)
STATS_COLUMNS = ("aligned", "matches", "indels", "gap_opens", "first_op",
                 "first_len", "last_op", "last_len")


def encode_rowT_all(codes: np.ndarray, mismatch: int, n_mismatch: bool):
    """Per-sequence (n, W) qm (int8) and am (int16) code planes for the
    row-scan wire: the untransposed form of nw_batch.encode_rowT, whose
    rows are gathered and transposed on the device per pair batch.  am is
    int16, as K2's wire is, so any mismatch score the CLI accepts fits."""
    amb = np.ones(16, dtype=bool)
    amb[[1, 2, 4, 8]] = False
    qm_lut = np.arange(16, dtype=np.int8)
    qm_lut[amb] = -1
    am_lut = np.full(16, mismatch, dtype=np.int16)
    am_lut[amb] = 0
    if n_mismatch:
        qm_lut[15] = -2
        am_lut[15] = mismatch
    return qm_lut[codes], am_lut[codes]


_argtypes_set = False


def _lib():
    global _argtypes_set
    lib = cuda_lib.load("nw_stats")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nw_stats_launch.argtypes = [p, p, p, p, i, i, i, i, p, p]
        lib.nw_stats_launch.restype = i
        _argtypes_set = True
    return lib


def stats_walk(dirs: torch.Tensor, mr: torch.Tensor, qlen: torch.Tensor,
               tlen: torch.Tensor) -> torch.Tensor:
    """Stats walk (K5) over K2m's planes dirs (M, N, B) uint16 and mr
    (M, N, B) uint8: (B, 8) int32 in STATS_COLUMNS order.  CUDA tensors
    launch csrc/nw_stats.cu; CPU tensors take the plain version."""
    M, N, B = dirs.shape
    if dirs.dtype != torch.uint16 or mr.dtype != torch.uint8 \
            or tuple(mr.shape) != (M, N, B) or mr.device != dirs.device:
        raise ValueError("dirs and mr must be uint16 and uint8 planes of "
                         "one shape on one device")
    for name, t in (("qlen", qlen), ("tlen", tlen)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,) \
                or t.device != dirs.device:
            raise ValueError("%s must be int32 (%d,) on %s"
                             % (name, B, dirs.device))
    if dirs.device.type == "cpu":
        cuda_lib.PLAIN_CALLS["nw_stats"] += 1
        return stats_walk_plain(dirs, mr, qlen, tlen)
    dirs, mr = dirs.contiguous(), mr.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    stats = torch.empty((B, 8), dtype=torch.int32, device=dirs.device)
    rc = _lib().nw_stats_launch(
        dirs.data_ptr(), mr.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
        M, N, B, M + N, stats.data_ptr(), cuda_lib.stream_ptr(dirs.device))
    cuda_lib.check(rc, "nw_stats")
    cuda_lib.LAUNCHES["nw_stats"] += 1
    return stats


def stats_walk_plain(dirs: torch.Tensor, mr: torch.Tensor,
                     qlen: torch.Tensor, tlen: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: one vectorised step over all pairs per walk
    step, as the JAX while_loop (allpairs_dev.py:108-167) takes them."""
    M, N, B = dirs.shape
    dev = dirs.device
    i64 = torch.int64
    flat = dirs.reshape(-1).view(torch.int16).to(torch.int32) & 0xFFFF
    mflat = mr.reshape(-1)
    brange = torch.arange(B, dtype=i64, device=dev)
    i = qlen.to(i64) - 1
    j = tlen.to(i64) - 1
    z = torch.zeros(B, dtype=i64, device=dev)
    prev, aligned, matches, indels, gap_opens = z, z, z, z, z
    cur_op, cur_len, last_op, last_len = z, z, z, z
    last_still = torch.ones(B, dtype=torch.bool, device=dev)
    for t in range(M + N):
        active = (i >= 0) | (j >= 0)
        if not bool(active.any()):
            break
        both = (i >= 0) & (j >= 0)
        idx = (i.clamp(0, M - 1) * N + j.clamp(0, N - 1)) * B + brange
        d = flat[idx].to(i64)
        rl = (d >> 4) & 0xFFF
        op_main = torch.where(
            (prev == OP_I) & ((d & DIR_EXTLEFT) != 0), OP_I,
            torch.where((prev == OP_D) & ((d & DIR_EXTUP) != 0), OP_D,
                        torch.where((d & DIR_LEFT) != 0, OP_I,
                                    torch.where((d & DIR_UP) != 0, OP_D,
                                                OP_M))))
        cnt_main = torch.where(op_main == OP_M, rl.clamp(min=1), 1)
        op_drain = torch.where(i >= 0, OP_D, OP_I)
        cnt_drain = (torch.where(i >= 0, i, j) + 1).clamp(max=4095)
        op = torch.where(both, op_main,
                         torch.where(active, op_drain, OP_NONE))
        cnt = torch.where(both, cnt_main, torch.where(active, cnt_drain, 0))
        aligned = aligned + cnt
        matches = matches + torch.where(both & (op == OP_M),
                                        mflat[idx].to(i64), 0)
        is_gap = (op == OP_D) | (op == OP_I)
        indels = indels + torch.where(is_gap, cnt, 0)
        gap_opens = gap_opens + (active & is_gap & (op != prev)).to(i64)
        cur_len = torch.where(active & (op == cur_op), cur_len + cnt,
                              torch.where(active, cnt, cur_len))
        cur_op = torch.where(active, op, cur_op)
        last_op = torch.where(active & (t == 0), op, last_op)
        cont = active & last_still & (op == last_op)
        last_len = last_len + torch.where(cont, cnt, 0)
        last_still = last_still & (~active | cont)
        i = i - torch.where((op == OP_D) | (op == OP_M), cnt, 0)
        j = j - torch.where((op == OP_I) | (op == OP_M), cnt, 0)
        prev = torch.where(active, op, prev)
    return torch.stack([aligned, matches, indels, gap_opens, cur_op,
                        cur_len, last_op, last_len], dim=1).to(torch.int32)


class AllPairsDevice:
    """The device-resident code planes of one run, and the triangle's
    pair batches through K2m and K5.

    A batch is PAIR_BATCH pairs, cut so that its direction and match planes
    (3 bytes a cell, W * W cells a pair) stay under PLANE_BUDGET; it stays
    a multiple of 32 (a warp of pairs) and at least 32.  The planes are
    allocated once per run and reused by every batch (K2m and K5 run in
    stream order); the tail batch launches at its own size.  Outputs do not
    depend on the batch size."""

    PAIR_BATCH = 4096
    PLANE_BUDGET = 4 * 10 ** 9

    def __init__(self, scheme, seqs: Sequence[bytes],
                 device: torch.device) -> None:
        self.device = torch.device(device)
        key = (scheme.match, scheme.mismatch, scheme.go_q_left,
               scheme.go_t_left, scheme.go_q_int, scheme.go_t_int,
               scheme.go_q_right, scheme.go_t_right, scheme.ge_q_left,
               scheme.ge_t_left, scheme.ge_q_int, scheme.ge_t_int,
               scheme.ge_q_right, scheme.ge_t_right, scheme.n_mismatch)
        n = len(seqs)
        maxlen = max((len(s) for s in seqs), default=1)
        # the exact padded width: one forward geometry per run, so padding
        # to a shape bucket would only add cells
        self.W = W = max((max(maxlen, 1) + 7) // 8 * 8, 16)
        codes = encode_padded(seqs, n, W)
        qm, am = encode_rowT_all(codes, scheme.mismatch, scheme.n_mismatch)
        lens = np.fromiter((max(len(s), 1) for s in seqs), dtype=np.int32,
                           count=n)
        self.raw_all, self.qm_all, self.am_all, self.lens = (
            torch.from_numpy(a).to(self.device) for a in (codes, qm, am, lens))
        self.batch = max(32, min(self.PAIR_BATCH,
                                 self.PLANE_BUDGET // (3 * W * W)) // 32 * 32)
        self.forward = build_forward(key, with_matches=True)

    def batch_wire(self, qp: torch.Tensor, tp: torch.Tensor):
        """K2m's inputs (qmT, amT, rqT, qlen, t4T, tlen) for the pairs
        (qp[k], tp[k]), int64 sequence numbers on the device: the rows
        gathered and transposed to the (W, B) wire on the device."""
        def rows(plane, idx):
            return plane.index_select(0, idx).t().contiguous()
        return (rows(self.qm_all, qp), rows(self.am_all, qp),
                rows(self.raw_all, qp), self.lens.index_select(0, qp),
                rows(self.raw_all, tp), self.lens.index_select(0, tp))

    def run(self, qpos: np.ndarray, tpos: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
        """All pairs (qpos[k], tpos[k]) through K2m and K5, batch by batch;
        nothing is fetched until the last batch is queued.  Returns the
        host's overflow (P,) bool and stats (P, 8) int32."""
        P = len(qpos)
        if P == 0:
            return np.zeros(0, dtype=bool), np.zeros((0, 8), dtype=np.int32)
        W = self.W
        dev = self.device
        stats = torch.empty((P, 8), dtype=torch.int32, device=dev)
        over = torch.empty(P, dtype=torch.bool, device=dev)
        with phase("dispatch"):
            B = min(self.batch, P)
            add("allpairs.pairs", P)
            add("allpairs.batches", -(-P // B))
            dirs_buf = torch.empty(W * W * B, dtype=torch.uint16, device=dev)
            mr_buf = torch.empty(W * W * B, dtype=torch.uint8, device=dev)
            qpos_d = torch.from_numpy(
                np.ascontiguousarray(qpos, dtype=np.int64)).to(dev)
            tpos_d = torch.from_numpy(
                np.ascontiguousarray(tpos, dtype=np.int64)).to(dev)
            for lo in range(0, P, B):
                hi = min(lo + B, P)
                b = hi - lo
                wire = self.batch_wire(qpos_d[lo:hi], tpos_d[lo:hi])
                planes = (dirs_buf[:W * W * b].view(W, W, b),
                          mr_buf[:W * W * b].view(W, W, b))
                _, over[lo:hi], dirs, mr = self.forward(*wire, out=planes)
                stats[lo:hi] = stats_walk(dirs, mr, wire[3], wire[5])
            # one copy of the stats and the flag together
            packed = torch.cat((stats, over.to(torch.int32)[:, None]), dim=1)
        with phase("stats_fetch"):
            if packed.is_cuda:
                host = torch.empty(packed.shape, dtype=packed.dtype,
                                   pin_memory=True)
                host.copy_(packed, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                with phase("stats_wait"):
                    event.synchronize()
                packed = host
            arr = packed.numpy()
        return arr[:, 8] != 0, arr[:, :8]

"""Device pipeline for all-vs-all global alignment (allpairs_global).

Counterpart of vsearch_tpu/ops/allpairs_dev.py, a redesign of reference
src/commands/allpairs_global.cpp:340-520: the sequence codes go to the
device once, the triangular pair schedule runs through it as index-pair
batches, and each batch runs the row-scan forward with the match plane
(K2m, ops/nw_rowscan.py) and then the stats walk (K5, csrc/nw_stats.cu) on
the same stream.  The stats stay on the device: the accept cascade runs
there (commands/allpairs.py accept_mask), and only a byte a pair of its
verdict and of the overflow flag reaches the host (queue_rows, take_rows);
only the accepted and the overflowing pairs are aligned again, for their
CIGARs or, overflowing, for their scores.  The triangle goes through in
chunks of batches (AllPairsDevice.chunks, queue_chunk), queued ahead of
the one the host works on (commands/allpairs.py), so that the host's
realign and writers run while the card runs K2m.

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
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_lib
from .nw import DIR_EXTLEFT, DIR_EXTUP, DIR_LEFT, DIR_UP
from .bundle import fetch_start, fetch_wait
from .nw_batch import (OP_D, OP_I, OP_M, OP_NONE, encode_padded,
                       encode_rows, scheme_key)
from .nw_rowscan import build_forward
from ..utils.phasetimer import add, phase

# stats columns (the JAX package's order)
STATS_COLUMNS = ("aligned", "matches", "indels", "gap_opens", "first_op",
                 "first_len", "last_op", "last_len")


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

    A batch is at most PAIR_BATCH pairs, as many as the plane budget holds
    (batch_size): on a card half of what it can give when the run starts,
    so that long sequences still fill the SMs, on the CPU PLANE_BUDGET.
    The planes are allocated at the run's first batch and reused by every
    later one (K2m and K5 run in stream order); the tail batch launches at
    its own size.  Outputs do not depend on the batch size."""

    PAIR_BATCH = 4096
    PLANE_BUDGET = 4 * 10 ** 9
    # K2m batches a chunk of the triangle (chunks).  A chunk costs the
    # host about 6 ms besides its pairs' realign and writers (its launches,
    # its accept, its realign call) and the card one realign launch,
    # whose time is set by the width, not the pairs (about 1 ms at 400 nt,
    # 10 ms at 1450 nt); the last chunk's host work runs with the card
    # idle.  At 4 launches a batch (the wire gathered once a chunk) and 70
    # or so of the chunk's own, two chunks of 32 batches in flight hold
    # about 400 launches, well inside the card's launch queue.  On one
    # H100 host, 32 ran 400 nt jobs (16 chunks of 43 ms of K2m) 6-7 %
    # faster than 16 and 1450 nt jobs (4 chunks) 2.6 % slower.  A
    # triangle of at most one chunk runs as one.
    CHUNK_BATCHES = 32

    def __init__(self, scheme, seqs: Sequence[bytes],
                 device: torch.device) -> None:
        self.device = torch.device(device)
        n = len(seqs)
        maxlen = max((len(s) for s in seqs), default=1)
        # the exact padded width: one forward geometry per run, so padding
        # to a shape bucket would only add cells
        self.W = W = max((max(maxlen, 1) + 7) // 8 * 8, 16)
        codes = encode_padded(seqs, n, W)
        # the untransposed row wire, gathered and transposed on the device
        # per pair batch (batches_wire)
        qm, am = encode_rows(codes, scheme.mismatch, scheme.n_mismatch)
        lens = np.fromiter((max(len(s), 1) for s in seqs), dtype=np.int32,
                           count=n)
        self.raw_all, self.qm_all, self.am_all, self.lens = (
            torch.from_numpy(a).to(self.device) for a in (codes, qm, am, lens))
        self.batch = self.batch_size(W, available_bytes(self.device))
        self.forward = build_forward(scheme_key(scheme), with_matches=True)
        self._planes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @classmethod
    def batch_size(cls, W: int, available: Optional[int]) -> int:
        """Pairs a batch of width W holds, where the card can give
        ``available`` bytes (None on the CPU): its direction and match
        planes (3 bytes a cell, W * W cells a pair) take at most half of
        them, or PLANE_BUDGET on the CPU; a multiple of 32 (a warp of
        pairs), at least 32."""
        budget = cls.PLANE_BUDGET if available is None else available // 2
        return max(32, min(cls.PAIR_BATCH, budget // (3 * W * W)) // 32 * 32)

    def batch_wire(self, qp: torch.Tensor, tp: torch.Tensor):
        """K2m's inputs (qmT, amT, rqT, qlen, t4T, tlen) for the pairs
        (qp[k], tp[k]), int64 sequence numbers on the device: the rows
        gathered and transposed to the (W, B) wire on the device."""
        return tuple(x[0] for x in self.batches_wire(qp, tp, len(qp)))

    def batches_wire(self, qp: torch.Tensor, tp: torch.Tensor, B: int):
        """batch_wire of len(qp) // B batches of B pairs at once, each
        input with a leading batch axis ((nb, W, B) and (nb, B)): one
        gather and one transpose a plane for all of them, and each
        batch's wire a contiguous view."""
        nb = len(qp) // B

        def rows(plane, idx):
            return (plane.index_select(0, idx).view(nb, B, self.W)
                    .transpose(1, 2).contiguous())
        return (rows(self.qm_all, qp), rows(self.am_all, qp),
                rows(self.raw_all, qp),
                self.lens.index_select(0, qp).view(nb, B),
                rows(self.raw_all, tp),
                self.lens.index_select(0, tp).view(nb, B))

    def _plane_buffers(self, B: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The direction and match plane buffers, for batches of up to B
        pairs: allocated once, at the first batch of the run, and again
        only for a larger batch."""
        cells = self.W * self.W * B
        if self._planes is None or self._planes[1].numel() < cells:
            self._planes = None
            with phase("planes"):
                self._planes = (
                    torch.empty(cells, dtype=torch.uint16,
                                device=self.device),
                    torch.empty(cells, dtype=torch.uint8, device=self.device))
            add("allpairs.plane_bytes", 3 * cells)
        return self._planes

    def run(self, qpos: torch.Tensor, tpos: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All pairs (qpos[k], tpos[k]), int64 sequence numbers on the
        device, through K2m and K5, batch by batch.  Returns the device's
        over (P,) bool and stats (P, 8) int32, queued and not waited for."""
        P = len(qpos)
        W = self.W
        dev = self.device
        stats = torch.empty((P, 8), dtype=torch.int32, device=dev)
        over = torch.empty(P, dtype=torch.bool, device=dev)
        if P == 0:
            return over, stats
        with phase("dispatch"):
            B = min(self.batch, P)
            add("allpairs.pairs", P)
            add("allpairs.batches", -(-P // B))
            add("allpairs.cells", P * W * W)
            dirs_buf, mr_buf = self._plane_buffers(B)
            # the full batches' wire gathered CHUNK_BATCHES at a time, the
            # tail batch's alone
            full = P - P % B
            group = B * self.CHUNK_BATCHES
            for lo in range(0, P, B):
                hi = min(lo + B, P)
                b = hi - lo
                if hi > full:
                    wire = self.batch_wire(qpos[lo:hi], tpos[lo:hi])
                else:
                    if lo % group == 0:
                        end = min(lo + group, full)
                        wires = self.batches_wire(qpos[lo:end],
                                                  tpos[lo:end], B)
                    wire = tuple(x[lo % group // B] for x in wires)
                planes = (dirs_buf[:W * W * b].view(W, W, b),
                          mr_buf[:W * W * b].view(W, W, b))
                _, over[lo:hi], dirs, mr = self.forward(*wire, out=planes)
                stats[lo:hi] = stats_walk(dirs, mr, wire[3], wire[5])
        return over, stats

    def chunks(self, P: int) -> List[Tuple[int, int]]:
        """The (lo, hi) row ranges of a triangle of P pairs in chunks of
        CHUNK_BATCHES batches, cut where run cuts the whole triangle."""
        step = self.batch * self.CHUNK_BATCHES
        bounds = [(lo, min(lo + step, P)) for lo in range(0, P, step)]
        add("allpairs.chunks", len(bounds))
        return bounds

    def queue_chunk(self, qpos: torch.Tensor, tpos: torch.Tensor, lo: int,
                    hi: int, accept):
        """The pairs lo:hi of (qpos[k], tpos[k]), int64 sequence numbers
        on the device, queued through K2m, K5 and ``accept(stats, qlens,
        tlens)``, a (n,) bool verdict on the device (an overflowing pair
        is never accepted there), then the verdict and the overflow flags
        queued for the host: take_rows(handle) gives their rows."""
        qp, tp = qpos[lo:hi], tpos[lo:hi]
        over, stats = self.run(qp, tp)
        with phase("accept"):
            ok = accept(stats, self.lens.index_select(0, qp),
                        self.lens.index_select(0, tp)) & ~over
        return queue_rows(ok, over, lo)


def available_bytes(device: torch.device) -> Optional[int]:
    """The bytes the card can give now: its free memory and what the
    caching allocator holds but has not handed out (so a second run in
    one process counts the first run's cached planes as free); None off
    a card."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def queue_rows(ok: torch.Tensor, over: torch.Tensor, lo: int = 0):
    """Queue the copy of a chunk's (n,) bool ``ok`` and ``over`` to the
    host, two bytes a pair (bundle.fetch_start), and return its handle
    for take_rows, which numbers the chunk's rows from ``lo``."""
    with phase("stats_fetch"):
        host, event = fetch_start(torch.stack((ok, over), dim=1))
        return host, event, lo


def take_rows(handle) -> Tuple[np.ndarray, np.ndarray]:
    """The rows where queue_rows' ``ok`` and ``over`` hold, each
    ascending, as host int64 arrays: the wait for its copy (that event
    alone, so the work queued after it runs on), then the indices taken
    on the host."""
    host, event, lo = handle
    with phase("stats_fetch"):
        rows = fetch_wait((host, event), "stats_wait")
        return np.flatnonzero(rows[:, 0]) + lo, np.flatnonzero(rows[:, 1]) + lo

"""Batched Needleman-Wunsch on the device: forward + backtrack.

Counterpart of vsearch_tpu/ops/nw_jax.py for the usearch_global and
clustering paths.  A batch of query x target pairs runs a forward and a
backtrack on the device; only the int16 ops wire (end-to-front) and the
scores reach the host, where the native tier's assemble_batch turns them
into CIGARs and statistics.  The scoring scheme picks one of two wires,
as nw_jax._build_kernels picks its kernels (nw_jax.py:388-409):

- the row wire, when the mismatch score fits int8: the row-scan forward
  (K2, ops/nw_rowscan.py) over the transposed, LUT-remapped query rows of
  encode_rowT, then the run-length backtrack (K3, backtrack_rle), ops
  op | count << 2;
- the codes wire otherwise: the wavefront forward (K6,
  ops/nw_wavefront.py) over the plain (B, M) codes of encode_padded, then
  the flat backtrack (K7, backtrack_flat), one plain op code per move.

Clustering's speculative prefetch (compact_gather, row wire only) packs
the candidate pairs that pass minmatches into dense lanes on the device,
without a host sync; on the codes wire it aligns each query's top-1
candidate (dispatch_indexed), as the JAX package does.

A batch of at most NATIVE_CELLS_LIMIT DP cells runs on the host C tier
instead (native vstpu_nw_align_batch).  The rule reads the batch alone,
so a batch takes the same route on every call and on every rank.

Under a mesh of several ranks (parallel/mesh.py) a device batch's pairs
are sharded: each rank aligns its slice of the rows and the results are
all-gathered.

Semantics are bit-identical to the reference engine and to ops/nw.py's
scalar oracle: cells are int32, overflow flags replicate the reference's
16-bit detection thresholds.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import cuda_lib, nw_rowscan, nw_wavefront
from .bundle import fetch_start, fetch_wait
from .nw import SHRT_MAX, AlignmentResult, ScoreScheme
from .score_dense import POS_SENTINEL
from ..parallel.mesh import active_mesh
from ..utils.maps import CHRMAP_4BIT

# op codes emitted by the backtrack
OP_NONE, OP_M, OP_D, OP_I = 0, 1, 2, 3

# speculative-prefetch ops rows kept on the device (compact_gather): a
# family pair backtracks in ~2 RLE entries and a reject-like random pair in
# ~100-170, so the cut covers nearly every lane while shrinking the fetch;
# lanes needing more entries go to the host aligner
PREFETCH_OPS_CAP = 256


def encode_padded(seqs: Sequence[bytes], rows: int, width: int) -> np.ndarray:
    """(rows, width) int8 matrix of 4-bit codes, zero padded."""
    out = np.zeros((rows, width), dtype=np.int8)
    if not seqs:
        return out
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64,
                       count=len(seqs))
    flat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    mask = np.arange(width)[None, :] < lens[:, None]
    padded_mask = np.zeros((rows, width), dtype=bool)
    padded_mask[:len(seqs)] = mask
    out[padded_mask] = CHRMAP_4BIT[flat].astype(np.int8)
    return out


def scheme_key(scheme: ScoreScheme) -> tuple:
    """The scheme's 15 scoring fields in the order build_forward of
    nw_rowscan and nw_wavefront takes them (nw_jax's key)."""
    return (scheme.match, scheme.mismatch, scheme.go_q_left,
            scheme.go_t_left, scheme.go_q_int, scheme.go_t_int,
            scheme.go_q_right, scheme.go_t_right, scheme.ge_q_left,
            scheme.ge_t_left, scheme.ge_q_int, scheme.ge_t_int,
            scheme.ge_q_right, scheme.ge_t_right, scheme.n_mismatch)


def encode_rows(codes: np.ndarray, mismatch: int, n_mismatch: bool):
    """The row-scan wire's (qm, am) of 4-bit codes, shaped as the codes,
    with the ambiguity/N remap folded in by LUT so the device does no
    per-batch preprocessing.

    qm (int8): the 4-bit code, or -1 for ambiguous codes (never equal to
    any target code => substitution falls through to am), or -2 for N
    under n_mismatch.  am (int16, wider than the TPU's int8 so that any
    mismatch score fits): the mismatch score, or 0 for ambiguous codes
    (reference score-matrix semantics, align_simd.cpp:1319-1342)."""
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


def encode_rowT(qseqs: Sequence[bytes], rows: int, width: int,
                mismatch: int, n_mismatch: bool):
    """Host-side wire prep for the row-scan kernel: (qmT, amT), the
    encode_rows of the zero-padded (rows, width) codes, transposed to
    (width, rows)."""
    qm, am = encode_rows(encode_padded(qseqs, rows, width), mismatch,
                         n_mismatch)
    return np.ascontiguousarray(qm.T), np.ascontiguousarray(am.T)


def _bucket(x: int, base: int = 64) -> int:
    """Shape bucket: powers of two with midpoints (1.5x ladder; from 512
    up also the 1.25x quarter-point).  DP cost is quadratic in the
    bucket, so at amplicon sizes the finer rung matters: L=600 pads to
    640 (1.14x cells) instead of 768 (1.64x)."""
    if x <= base:
        return base
    b = base
    while b < x:
        if b >= 512 and x <= b + b // 4:
            return b + b // 4
        if x <= b + b // 2:
            return b + b // 2
        b *= 2
    return b


_bt_argtypes_set = False


def _bt_lib():
    global _bt_argtypes_set
    lib = cuda_lib.load("nw_backtrack")
    if not _bt_argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nw_backtrack_launch.argtypes = [p, p, p, i, i, i, i, p, p]
        lib.nw_backtrack_launch.restype = i
        lib.nw_backtrack_flat_launch.argtypes = [p, p, p, i, i, i, p, p]
        lib.nw_backtrack_flat_launch.restype = i
        _bt_argtypes_set = True
    return lib


def backtrack_rle(dirs: torch.Tensor, qlen: torch.Tensor,
                  tlen: torch.Tensor) -> torch.Tensor:
    """RLE backtrack over the row-scan forward's dirs (M, N, B) uint16.

    Returns ops (S=M+N, B) int16 in end-to-front order, run-length encoded
    as op | count << 2 (count 1..4095).  CUDA tensors launch K3; CPU
    tensors take the plain version."""
    M, N, B = dirs.shape
    if dirs.dtype != torch.uint16:
        raise ValueError("dirs must be uint16, got %s" % dirs.dtype)
    for name, t in (("qlen", qlen), ("tlen", tlen)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,) \
                or t.device != dirs.device:
            raise ValueError("%s must be int32 (%d,) on %s"
                             % (name, B, dirs.device))
    if dirs.device.type == "cpu":
        cuda_lib.PLAIN_CALLS["nw_backtrack"] += 1
        return backtrack_rle_plain(dirs, qlen, tlen)
    dirs, qlen, tlen = dirs.contiguous(), qlen.contiguous(), tlen.contiguous()
    S = M + N
    # K3 stores only the walked entries: the rest of the wire is these 0s
    ops = torch.zeros((S, B), dtype=torch.int16, device=dirs.device)
    rc = _bt_lib().nw_backtrack_launch(
        dirs.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), M, N, B, S,
        ops.data_ptr(), cuda_lib.stream_ptr(dirs.device))
    cuda_lib.check(rc, "nw_backtrack")
    cuda_lib.LAUNCHES["nw_backtrack"] += 1
    return ops


def backtrack_rle_plain(dirs: torch.Tensor, qlen: torch.Tensor,
                        tlen: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: one vectorised step over all lanes per op
    (nw_jax.py:320-377)."""
    M, N, B = dirs.shape
    S = M + N
    dev = dirs.device
    flat = dirs.reshape(-1).view(torch.int16).to(torch.int32) & 0xFFFF
    brange = torch.arange(B, dtype=torch.int64, device=dev)
    i = qlen.to(torch.int64) - 1
    j = tlen.to(torch.int64) - 1
    prev = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = torch.zeros((S, B), dtype=torch.int16, device=dev)
    for t in range(S):
        active = (i >= 0) | (j >= 0)
        if not bool(active.any()):
            break
        both = (i >= 0) & (j >= 0)
        idx = (i.clamp(0, M - 1) * N + j.clamp(0, N - 1)) * B + brange
        d = flat[idx].to(torch.int64)
        rl = (d >> 4) & 0xFFF
        op_main = torch.where(
            (prev == OP_I) & ((d & 8) != 0), OP_I,
            torch.where((prev == OP_D) & ((d & 4) != 0), OP_D,
                        torch.where((d & 2) != 0, OP_I,
                                    torch.where((d & 1) != 0, OP_D, OP_M))))
        cnt_main = torch.where(op_main == OP_M, rl.clamp(min=1), 1)
        op_drain = torch.where(i >= 0, OP_D, OP_I)
        cnt_drain = (torch.where(i >= 0, i, j) + 1).clamp(max=4095)
        op = torch.where(both, op_main,
                         torch.where(active, op_drain, OP_NONE))
        cnt = torch.where(both, cnt_main,
                          torch.where(active, cnt_drain, 0))
        ops[t] = (op | (cnt << 2)).to(torch.int16)
        i = i - torch.where((op == OP_D) | (op == OP_M), cnt, 0)
        j = j - torch.where((op == OP_I) | (op == OP_M), cnt, 0)
        prev = torch.where(active, op, prev)
    return ops


def backtrack_flat(dirs: torch.Tensor, qlen: torch.Tensor,
                   tlen: torch.Tensor) -> torch.Tensor:
    """Flat backtrack over the wavefront forward's dirs (D, B, Ms) uint8,
    cell (i, j) of pair b at [i + j, b, i].

    Returns ops (S=D+1, B) int16 in end-to-front order, one plain op code
    (1-3) per move and 0 after the walk.  CUDA tensors launch K7; CPU
    tensors take the plain version."""
    D, B, Ms = dirs.shape
    if dirs.dtype != torch.uint8:
        raise ValueError("dirs must be uint8, got %s" % dirs.dtype)
    for name, t in (("qlen", qlen), ("tlen", tlen)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,) \
                or t.device != dirs.device:
            raise ValueError("%s must be int32 (%d,) on %s"
                             % (name, B, dirs.device))
    if dirs.device.type == "cpu":
        cuda_lib.PLAIN_CALLS["nw_backtrack_flat"] += 1
        return backtrack_flat_plain(dirs, qlen, tlen)
    dirs, qlen, tlen = dirs.contiguous(), qlen.contiguous(), tlen.contiguous()
    ops = torch.empty((D + 1, B), dtype=torch.int16, device=dirs.device)
    rc = _bt_lib().nw_backtrack_flat_launch(
        dirs.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), D, B, Ms,
        ops.data_ptr(), cuda_lib.stream_ptr(dirs.device))
    cuda_lib.check(rc, "nw_backtrack_flat")
    cuda_lib.LAUNCHES["nw_backtrack_flat"] += 1
    return ops


def backtrack_flat_plain(dirs: torch.Tensor, qlen: torch.Tensor,
                         tlen: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: one vectorised move over all lanes per step
    (nw_jax.py:288-317), drain moves included."""
    D, B, Ms = dirs.shape
    dev = dirs.device
    flat = dirs.reshape(-1)
    brange = torch.arange(B, dtype=torch.int64, device=dev) * Ms
    i = qlen.to(torch.int64) - 1
    j = tlen.to(torch.int64) - 1
    prev = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = torch.zeros((D + 1, B), dtype=torch.int16, device=dev)
    for t in range(D + 1):
        active = (i >= 0) | (j >= 0)
        if not bool(active.any()):
            break
        both = (i >= 0) & (j >= 0)
        idx = ((i + j).clamp(0, D - 1) * (B * Ms) + brange
               + i.clamp(0, Ms - 1))
        w = flat[idx].to(torch.int64)
        op_main = torch.where(
            (prev == OP_I) & ((w & 8) != 0), OP_I,
            torch.where((prev == OP_D) & ((w & 4) != 0), OP_D,
                        torch.where((w & 2) != 0, OP_I,
                                    torch.where((w & 1) != 0, OP_D, OP_M))))
        op = torch.where(both, op_main,
                         torch.where(active, torch.where(i >= 0, OP_D, OP_I),
                                     OP_NONE))
        ops[t] = op.to(torch.int16)
        i = i - ((op == OP_D) | (op == OP_M)).to(torch.int64)
        j = j - ((op == OP_I) | (op == OP_M)).to(torch.int64)
        prev = torch.where(active, op, prev)
    return ops


def gather_pairs(mesh, score: torch.Tensor, overflow: torch.Tensor,
                 ops: torch.Tensor):
    """The whole batch's (score, overflow, ops) on every rank from each
    rank's slice of its pairs (nw_jax.py:466-470): ops gathered along its
    pair axis, score and overflow as one (2, b) tensor."""
    meta = mesh.all_gather(torch.stack([score, overflow.to(torch.int32)]),
                           1)
    return meta[0], meta[1].bool(), mesh.all_gather(ops, 1)


def gather_align(forward, qside, qlen, pos, db_codes, tlen_by_pos, N: int,
                 row_wire: bool = True):
    """Forward + backtrack over pairs whose targets live on the device:
    target rows are gathered by index position, so a dispatch uploads only
    the query side (nw_jax._gather_align_kernel).  qside is (qmT, amT) on
    the row wire (targets transposed for K2, then K3) and q4 on the codes
    wire (targets as gathered, db_codes[p][:, :N], for K6, then K7).

    Under a mesh whose ranks split the pairs evenly, each rank aligns its
    slice and the results are all-gathered (nw_jax.py:517-561; the codes
    are replicated on every rank)."""
    mesh = active_mesh()
    rows = mesh.rows(qlen.shape[0]) if mesh is not None else None
    if rows is not None:
        lo, hi = rows
        qside = (tuple(x[:, lo:hi].contiguous() for x in qside) if row_wire
                 else qside[lo:hi])
        qlen, pos = qlen[lo:hi], pos[lo:hi]
    p = pos.to(torch.int64).clamp(0, db_codes.shape[0] - 1)
    t4 = db_codes[p][:, :N]
    tlen = torch.clamp(tlen_by_pos[p], max=N).to(torch.int32)
    if not row_wire:
        score, overflow, dirs = forward(qside, qlen, t4.contiguous(), tlen)
        out = score, overflow, backtrack_flat(dirs, qlen, tlen)
    else:
        score, overflow, dirs = forward(*qside, qlen, t4.t().contiguous(),
                                        tlen)
        out = score, overflow, backtrack_rle(dirs, qlen, tlen)
    return out if rows is None else gather_pairs(mesh, *out)


def compact_lanes(vals: torch.Tensor, idx: torch.Tensor, mm: torch.Tensor,
                  K: int, R: int, n: int) -> torch.Tensor:
    """(R,) int32 lane list of the (query, candidate) pairs among each
    query's top K whose count passes its minmatches and whose position is
    occupied: lane value c * qp + q for candidate rank c of query q, in
    increasing order, truncated at R and filled with qp * K.  Candidate-
    rank-major (all rank-0 candidates first, nw_jax.py:607-613), so a
    truncation drops deep candidates, not whole queries.

    The equal of jnp.nonzero(valid.T.reshape(-1), size=R, fill_value=qp*K)
    without a host sync: a cumsum places each valid pair and a scatter
    writes it into a buffer pre-filled with qp * K (pairs past R go to a
    discarded extra slot)."""
    qp = vals.shape[0]
    dev = vals.device
    valid = (vals[:, :K] >= mm[:, None]) & (idx[:, :K] < n)
    flat = valid.t().reshape(-1)
    dest = torch.cumsum(flat, 0) - 1
    keep = flat & (dest < R)
    lane = torch.full((R + 1,), qp * K, dtype=torch.int32, device=dev)
    lane.scatter_(0, torch.where(keep, dest, R),
                  torch.arange(qp * K, dtype=torch.int32, device=dev))
    return lane[:R]


def compact_gather(forward, qmT, amT, qlens, vals, idx, mm, K: int, R: int,
                   db_codes, tlen_by_pos, N: int, n: int):
    """Device-side candidate compaction + gather-align (counterpart of
    nw_jax._compact_gather_kernel, nw_jax.py:586-654).

    From the top-k output (vals, idx) (qp, k) and per-query minmatches mm
    (qp,), aligns the lanes of compact_lanes: query operands gathered by
    lane, targets by index position.  One K2 + K3 call covers all R lanes
    (K2 takes any batch; the TPU split at 1024 lanes was a VMEM limit).
    Returns (meta (5, R) int32 -- rows q_idx, position (2^30 on dead
    lanes), score, overflow, nsteps -- and ops (min(S, PREFETCH_OPS_CAP),
    R) int16).  nsteps counts a lane's nonzero ops entries before the cut:
    a lane with nsteps above the kept rows must go to the host aligner."""
    qp = vals.shape[0]
    lane = compact_lanes(vals, idx, mm, K, R, n)
    live = lane < qp * K
    lane_c = torch.where(live, lane, 0).long()
    q_idx = lane_c % qp
    c_idx = lane_c // qp
    pos = idx[:, :K].reshape(-1)[q_idx * K + c_idx]
    pos = torch.where(live, pos, 0)
    ql = torch.where(live, qlens[q_idx], 1)
    score, over, ops = gather_align(forward, (qmT[:, q_idx], amT[:, q_idx]),
                                    ql, pos, db_codes, tlen_by_pos, N)
    nsteps = (ops != 0).sum(dim=0, dtype=torch.int32)
    meta = torch.stack([q_idx.to(torch.int32),
                        torch.where(live, pos, POS_SENTINEL),
                        score, over.to(torch.int32), nsteps])
    return meta, ops[:PREFETCH_OPS_CAP]


class _Queued(NamedTuple):
    """A device alignment queued by BatchAligner.align_pairs_begin: its
    pair chunks and the fetch of their outputs (bundle.fetch_start)."""
    chunks: list
    fetch: tuple


class BatchAligner:
    """Device-batched aligner with host CIGAR/stat assembly."""

    # pair-batch geometry ladder (the kernels take any batch; the ladder
    # caps one dispatch at 1024 pairs)
    PAIR_BUCKETS = (128, 256, 512, 1024)

    # a batch of at most this many DP cells runs on the host C tier, a
    # larger one on the device
    NATIVE_CELLS_LIMIT = 8_000_000

    def __init__(self, scheme: ScoreScheme, device: torch.device) -> None:
        self.scheme = scheme
        self.device = torch.device(device)
        self._key = scheme_key(scheme)
        # the wire, once per scheme (nw_jax.py:393-394): the JAX package
        # takes the row scan only when the mismatch score fits its int8
        # wire, and the port keeps that ladder (its own K2 takes int16)
        self.row_wire = -128 <= scheme.mismatch <= 127
        if self.row_wire:
            self._forward = nw_rowscan.build_forward(self._key)
        else:
            self._forward = nw_wavefront.build_forward(self._key)

    def align_pairs(self, qseqs: Sequence[bytes],
                    tseqs: Sequence[bytes]) -> List[AlignmentResult]:
        return self.align_pairs_end(self.align_pairs_begin(qseqs, tseqs))

    def align_pairs_begin(self, qseqs: Sequence[bytes],
                          tseqs: Sequence[bytes]):
        """The first half of align_pairs: the host tier's results, or the
        device's launches queued on the current stream and not waited
        for.  align_pairs_end(handle) gives the results, so the caller
        may queue other work on the stream and do host work between.
        Every rank of a mesh counts the cells of the whole batch, so all
        take its route."""
        B = len(qseqs)
        if B == 0:
            return []
        cells = sum(len(q) * len(t) for q, t in zip(qseqs, tseqs))
        if cells <= self.NATIVE_CELLS_LIMIT:
            native_res = self._align_pairs_native(qseqs, tseqs)
            if native_res is not None:
                return native_res
        # dispatch every chunk before fetching any
        cap = self.PAIR_BUCKETS[-1]
        chunks = [(qseqs[lo:lo + cap], tseqs[lo:lo + cap])
                  for lo in range(0, B, cap)]
        return _Queued(chunks, fetch_start(
            [self._dispatch(qc, tc) for qc, tc in chunks]))

    def align_pairs_end(self, handle) -> List[AlignmentResult]:
        """The results of align_pairs_begin's handle, waiting for the
        device's work where it queued some."""
        if not isinstance(handle, _Queued):
            return handle
        out: List[AlignmentResult] = []
        for (qc, tc), fetched in zip(handle.chunks,
                                     fetch_wait(handle.fetch, "align_wait")):
            out.extend(self.assemble_columns(*fetched, qc, tc))
        return out

    def _align_pairs_native(self, qseqs: Sequence[bytes],
                            tseqs: Sequence[bytes]
                            ) -> Optional[List[AlignmentResult]]:
        """Host C tier: threaded scalar NW with identical semantics
        (native/vsearch_tpu_native.c vstpu_nw_align_batch)."""
        from .. import native
        res = native.nw_align_batch(qseqs, tseqs, self._key)
        if res is None:
            return None
        return [AlignmentResult(SHRT_MAX, "", 0, 0, 0, 0) if overflow
                else AlignmentResult(score, cigar, aligned, matches, mism,
                                     gaps)
                for (score, overflow, aligned, matches, mism, gaps, cigar)
                in res]

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, non_blocking=True)

    def dispatch_indexed(self, qseqs: Sequence[bytes], rows: int,
                         pos: torch.Tensor, db_codes: torch.Tensor,
                         tlen_by_pos: torch.Tensor, N: int):
        """Launch alignment of each query against a device-resident target
        selected by index position (e.g. the top-1 column of a top-k
        result).  ``pos`` is a device (rows,) tensor, so no host sync
        happens here; only the query codes are uploaded."""
        qlens = np.ones(rows, dtype=np.int32)
        for i, s in enumerate(qseqs):
            qlens[i] = max(len(s), 1)
        M = _bucket(max(len(s) for s in qseqs))
        if self.row_wire:
            qmT, amT = encode_rowT(qseqs, rows, M, self.scheme.mismatch,
                                   self.scheme.n_mismatch)
            qside = (self._upload(qmT), self._upload(amT))
        else:
            qside = self._upload(encode_padded(qseqs, rows, M))
        return gather_align(self._forward, qside, self._upload(qlens), pos,
                            db_codes, tlen_by_pos, N, self.row_wire)

    def dispatch_compact(self, qseqs: Sequence[bytes], qp: int,
                         vals: torch.Tensor, idx: torch.Tensor,
                         mm: np.ndarray, K: int, R: int,
                         db_codes: torch.Tensor, tlen_by_pos: torch.Tensor,
                         N: int, n: int):
        """Compacted speculative alignment of the top-K candidates that
        pass minmatches, packed into R device lanes computed on the device
        from the un-fetched top-k output (compact_gather).  Only the query
        codes and mm are uploaded.  Row wire only: the ops cut at
        PREFETCH_OPS_CAP rows assumes run-length ops (nw_jax.py:601-603)."""
        if not self.row_wire:
            raise ValueError("the compacted prefetch needs the row wire")
        qlens = np.ones(qp, dtype=np.int32)
        for i, s in enumerate(qseqs):
            qlens[i] = max(len(s), 1)
        M = _bucket(max(len(s) for s in qseqs))
        qmT, amT = encode_rowT(qseqs, qp, M, self.scheme.mismatch,
                               self.scheme.n_mismatch)
        return compact_gather(
            self._forward, self._upload(qmT), self._upload(amT),
            self._upload(qlens), vals, idx,
            self._upload(np.ascontiguousarray(mm, dtype=np.int32)), K, R,
            db_codes, tlen_by_pos, N, n)

    def assemble_one(self, score: int, ops_col: np.ndarray, qseq: bytes,
                     tseq: bytes) -> AlignmentResult:
        """Host assembly of one prefetched (score, ops) row."""
        return self._assemble(score, ops_col, qseq, tseq)

    def _dispatch(self, qseqs: Sequence[bytes], tseqs: Sequence[bytes]):
        """Encode, upload and launch one pair chunk; returns device tensors.
        Under a mesh whose ranks split the padded batch evenly, each rank
        encodes and aligns its slice of the rows and the results are
        all-gathered (nw_jax._build_kernels_sharded, nw_jax.py:447-501);
        otherwise every rank runs the whole batch."""
        B = len(qseqs)
        qlens = np.array([len(q) for q in qseqs], dtype=np.int32)
        tlens = np.array([len(t) for t in tseqs], dtype=np.int32)
        M = _bucket(int(qlens.max()))
        N = _bucket(int(tlens.max()))
        Bp = next(b for b in self.PAIR_BUCKETS if b >= B)
        qlens_p = np.ones(Bp, dtype=np.int32)
        qlens_p[:B] = qlens
        tlens_p = np.ones(Bp, dtype=np.int32)
        tlens_p[:B] = tlens
        mesh = active_mesh()
        rows = mesh.rows(Bp) if mesh is not None else None
        lo, hi = rows or (0, Bp)
        qseqs, tseqs = qseqs[lo:hi], tseqs[lo:hi]
        qlen_d = self._upload(qlens_p[lo:hi])
        tlen_d = self._upload(tlens_p[lo:hi])
        if not self.row_wire:
            score, overflow, dirs = self._forward(
                self._upload(encode_padded(qseqs, hi - lo, M)), qlen_d,
                self._upload(encode_padded(tseqs, hi - lo, N)), tlen_d)
            out = score, overflow, backtrack_flat(dirs, qlen_d, tlen_d)
        else:
            qmT, amT = encode_rowT(qseqs, hi - lo, M, self.scheme.mismatch,
                                   self.scheme.n_mismatch)
            t4T = np.ascontiguousarray(encode_padded(tseqs, hi - lo, N).T)
            score, overflow, dirs = self._forward(
                self._upload(qmT), self._upload(amT), qlen_d,
                self._upload(t4T), tlen_d)
            out = score, overflow, backtrack_rle(dirs, qlen_d, tlen_d)
        return out if rows is None else gather_pairs(mesh, *out)

    def assemble_columns(self, score, overflow, ops: np.ndarray,
                         qseqs: Sequence[bytes], tseqs: Sequence[bytes]
                         ) -> List[AlignmentResult]:
        """Assemble the first len(qseqs) columns of a fetched (S, B) ops
        matrix into AlignmentResults (one threaded native call for the
        whole batch; overflow columns become SHRT_MAX sentinels)."""
        from .. import native
        B = len(qseqs)
        results: List[Optional[AlignmentResult]] = [None] * B
        live = [b for b in range(B) if not overflow[b]]
        batch = native.assemble_batch(
            ops, live, [qseqs[b] for b in live], [tseqs[b] for b in live],
            self.scheme.n_mismatch) if live else []
        if batch is not None:
            for b, (cigar, aligned, matches, mism, gaps) in zip(live, batch):
                results[b] = AlignmentResult(int(score[b]), cigar, aligned,
                                             matches, mism, gaps)
        else:
            for b in live:
                results[b] = self._assemble(int(score[b]), ops[:, b],
                                            qseqs[b], tseqs[b])
        for b in range(B):
            if results[b] is None:
                results[b] = AlignmentResult(SHRT_MAX, "", 0, 0, 0, 0)
        return results

    def _assemble(self, score: int, ops_rev: np.ndarray, qseq: bytes,
                  tseq: bytes) -> AlignmentResult:
        from .. import native
        res = native.assemble(ops_rev, qseq, tseq, self.scheme.n_mismatch)
        if res is not None:
            cigar, aligned, matches, mismatches, gaps = res
            return AlignmentResult(score, cigar, aligned, matches,
                                   mismatches, gaps)
        vals = ops_rev[ops_rev != OP_NONE][::-1].astype(np.int64)
        # decode run-length entries (op | count << 2)
        fwd = np.repeat(vals & 3, np.maximum(vals >> 2, 1))
        aligned = int(fwd.size)
        is_m = fwd == OP_M
        is_d = fwd == OP_D
        is_i = fwd == OP_I
        # per-op sequence positions
        qstep = (is_m | is_d).astype(np.int64)
        tstep = (is_m | is_i).astype(np.int64)
        qpos = np.cumsum(qstep) - qstep
        tpos = np.cumsum(tstep) - tstep
        q4 = CHRMAP_4BIT[np.frombuffer(qseq, dtype=np.uint8)].astype(np.int64)
        t4 = CHRMAP_4BIT[np.frombuffer(tseq, dtype=np.uint8)].astype(np.int64)
        mq = q4[qpos[is_m]]
        mt = t4[tpos[is_m]]
        equiv = (mq & mt) != 0
        if self.scheme.n_mismatch:
            equiv &= (mq != 15) & (mt != 15)
        matches = int(equiv.sum())
        mismatches = int(is_m.sum()) - matches
        # gap runs: transitions into D or I
        prev = np.concatenate(([OP_NONE], fwd[:-1]))
        gaps = int(((is_d) & (prev != OP_D)).sum()
                   + ((is_i) & (prev != OP_I)).sum())
        return AlignmentResult(score, _ops_array_to_cigar(fwd), aligned,
                               matches, mismatches, gaps)


_OP_CHARS = {OP_M: "M", OP_D: "D", OP_I: "I"}


def _ops_array_to_cigar(fwd: np.ndarray) -> str:
    if fwd.size == 0:
        return ""
    change = np.nonzero(np.diff(fwd))[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [fwd.size]))
    parts = []
    for s, e in zip(starts, ends):
        run = e - s
        ch = _OP_CHARS[int(fwd[s])]
        parts.append(("%d%s" % (run, ch)) if run > 1 else ch)
    return "".join(parts)

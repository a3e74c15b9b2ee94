"""Shared-k-mer counts and exact top-k for one index block (kernels K1
and K4).

Counterpart of vsearch_tpu/ops/score_mxu.py.  The counts of a query chunk
against a packed-bit index block are

    counts(Q, pos) = sum over the query's k-mer ids of bit pos of bits[id]

computed by the hand-written CUDA kernels of csrc/score_dense.cu (one
thread per packed word, adding the words of the query's own ids into bit
planes with carry-save adders -- see the note there) or, for tensors on
the CPU, by their plain PyTorch versions below.  K1 folds the position
key of a static index, K4 the rank key of the growing index
(ops/score_grow.py).  Top-k selection is ``torch.topk``, where the JAX
package had lax.top_k outside its kernels.

Exactness: the packed key count<<17 | (2^17-1-pos) is a strict total order
equal to the reference min-heap's (count desc, position asc; positions are
presorted by (length, seqno), ops/score.py), exact while count < 2^14 and
block positions <= 2^17.  Beyond that the counts-only path builds the
int64 key count<<32 | (2^32-1-pos), since torch.topk promises no order
among equal values.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from . import cuda_lib

# positions are rounded to this tile when blocks are sized (ops/score.py)
NBLK = 4096

# packed top-k key: count<<17 | (2^17-1-pos); exact iff count < 2^14
DENSE_MAXK_LIMIT = 16383
POS_BITS = 17
POS_SENTINEL = 2 ** 30

# rank key of the growing index: count<<20 | (RANK_MAX - rank); exact while
# count <= MAX_COUNT and every occupied rank is below RANK_MAX
RANK_BITS = 20
RANK_MAX = (1 << RANK_BITS) - 1
MAX_COUNT = (1 << (31 - RANK_BITS)) - 1

_argtypes_set = False


def _lib():
    global _argtypes_set
    lib = cuda_lib.load("score_dense")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.score_dense_launch.argtypes = [p, i, i, p, i, i, i, i, i, p, p]
        lib.score_dense_launch.restype = i
        lib.score_ranked_launch.argtypes = [p, i, i, p, i, i, i, p, p, p]
        lib.score_ranked_launch.restype = i
        _argtypes_set = True
    return lib


def _as_i32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    if t.dtype != torch.int32:
        raise TypeError("packed bits must be uint32 or int32, not %s"
                        % t.dtype)
    return t


def _operands(Kbits: torch.Tensor, bits: torch.Tensor, *more: torch.Tensor):
    """Kbits and bits as int32, after the checks K1 and K4 share: Kbits has
    the words of V = bits rows, and off the CPU every operand lies on one
    CUDA device, contiguous except bits, whose rows need only be (a column
    prefix of a wider matrix: the kernels take its row stride)."""
    Kbits = _as_i32(Kbits)
    bits = _as_i32(bits)
    qw = Kbits.shape[1]
    V = bits.shape[0]
    if qw != (V + 31) // 32:
        raise ValueError("Kbits has %d words per row, V=%d needs %d"
                         % (qw, V, (V + 31) // 32))
    if Kbits.device.type != "cpu":
        ops = (Kbits, bits) + more
        if not (Kbits.is_cuda
                and all(t.device == Kbits.device for t in ops)):
            raise ValueError("the operands must lie on the same CUDA device")
        if not all(t.is_contiguous() for t in (Kbits,) + more) \
                or bits.stride(1) != 1 or bits.stride(0) < bits.shape[1]:
            raise ValueError("the operands must be contiguous, bits in its "
                             "rows")
    return Kbits, bits


def counts_or_keys(Kbits: torch.Tensor, bits: torch.Tensor, n_real: int,
                   pack: bool) -> torch.Tensor:
    """(qp, 32*words) int32 counts in position order, or with ``pack`` the
    packed keys (-1 at positions >= n_real).  Kbits (qp, ceil(V/32)) and
    bits (V, words) are packed uint32/int32, bits' rows contiguous.  CUDA
    tensors launch K1; CPU tensors take the plain version."""
    Kbits, bits = _operands(Kbits, bits)
    qp, qw = Kbits.shape
    V, words = bits.shape
    if Kbits.device.type == "cpu":
        cuda_lib.PLAIN_CALLS["score_dense"] += 1
        return counts_or_keys_plain(Kbits, bits, n_real, pack)
    out = torch.empty((qp, words * 32), dtype=torch.int32,
                      device=Kbits.device)
    rc = _lib().score_dense_launch(
        Kbits.data_ptr(), qp, qw, bits.data_ptr(), V, words, bits.stride(0),
        int(n_real), int(pack), out.data_ptr(),
        cuda_lib.stream_ptr(Kbits.device))
    cuda_lib.check(rc, "score_dense")
    cuda_lib.LAUNCHES["score_dense"] += 1
    return out


def counts_or_keys_plain(Kbits: torch.Tensor, bits: torch.Tensor,
                         n_real: int, pack: bool) -> torch.Tensor:
    """Plain version of K1: per query, gather its k-mer rows, unpack and
    sum them; then the same key fold."""
    Kbits = _as_i32(Kbits)
    bits = _as_i32(bits)
    qp = Kbits.shape[0]
    V, words = bits.shape
    dev = Kbits.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    out = torch.zeros((qp, words * 32), dtype=torch.int32, device=dev)
    onehot = ((Kbits[:, :, None] >> shifts) & 1).reshape(qp, -1)[:, :V]
    for q in range(qp):
        ids = onehot[q].nonzero()[:, 0]
        if ids.numel():
            rows = bits[ids]                              # (L, words)
            out[q] = ((rows[:, :, None] >> shifts) & 1).sum(
                dim=0, dtype=torch.int32).reshape(-1)
    if pack:
        pos = torch.arange(words * 32, dtype=torch.int32, device=dev)
        key = out * (1 << POS_BITS) + ((1 << POS_BITS) - 1 - pos)
        out = torch.where(pos < n_real, key, torch.full_like(key, -1))
    return out


def ranked_keys(Kbits: torch.Tensor, bits: torch.Tensor,
                rank: torch.Tensor) -> torch.Tensor:
    """(qp, 32*words) int32 rank keys count<<20 | (RANK_MAX - rank[pos]),
    -1 where rank[pos] >= RANK_MAX (an empty position).  Kbits (qp,
    ceil(V/32)) and bits (V, words) are packed uint32/int32 (bits' rows
    contiguous: a column prefix of a wider matrix scans those positions
    only), rank (32*words,) int32 in position order.  CUDA tensors launch
    K4; CPU tensors take the plain version."""
    Kbits, bits = _operands(Kbits, bits, rank)
    qp, qw = Kbits.shape
    V, words = bits.shape
    if rank.dtype != torch.int32 or tuple(rank.shape) != (words * 32,):
        raise ValueError("rank must be int32 (%d,), got %s %s"
                         % (words * 32, rank.dtype, tuple(rank.shape)))
    if Kbits.device.type == "cpu":
        cuda_lib.PLAIN_CALLS["score_ranked"] += 1
        return ranked_keys_plain(Kbits, bits, rank)
    out = torch.empty((qp, words * 32), dtype=torch.int32,
                      device=Kbits.device)
    rc = _lib().score_ranked_launch(
        Kbits.data_ptr(), qp, qw, bits.data_ptr(), V, words, bits.stride(0),
        rank.data_ptr(), out.data_ptr(), cuda_lib.stream_ptr(Kbits.device))
    cuda_lib.check(rc, "score_ranked")
    cuda_lib.LAUNCHES["score_ranked"] += 1
    return out


def ranked_keys_plain(Kbits: torch.Tensor, bits: torch.Tensor,
                      rank: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: K1's plain counts, then the rank fold
    (score_mxu.py:226-230)."""
    counts = counts_or_keys_plain(Kbits, bits, 0, pack=False)
    key = counts * (1 << RANK_BITS) + (RANK_MAX - rank)[None, :]
    return torch.where(rank[None, :] < RANK_MAX, key,
                       torch.full_like(key, -1))


def dense_topk_ranked(hashsize: int, words: int, qp: int, k: int):
    """counts + exact rank-keyed top-k for the growing index.

    Returns a function of (Kbits (qp, hashsize/32), bits (hashsize, words),
    rank (32*words,) int32) giving (counts (qp, k) int32, positions (qp, k)
    int32) in reference heap order, with count -1 and position 2^30 where
    fewer than k positions are occupied (the contract of
    score_mxu.dense_topk_ranked_kernel).  Occupied ranks are distinct, so
    the keys are and torch.topk's order is unique."""
    n_cols = words * 32
    if k > n_cols:
        raise ValueError("k=%d exceeds the index's %d columns" % (k, n_cols))

    def run(Kbits: torch.Tensor, bits: torch.Tensor, rank: torch.Tensor):
        if tuple(Kbits.shape) != (qp, (hashsize + 31) // 32) \
                or tuple(bits.shape) != (hashsize, words):
            raise ValueError("dense_topk_ranked geometry mismatch")
        v, pos = torch.topk(ranked_keys(Kbits, bits, rank), k, dim=1)
        valid = v >= 0
        return (torch.where(valid, v >> RANK_BITS, torch.full_like(v, -1)),
                torch.where(valid, pos.to(torch.int32),
                            torch.full_like(v, POS_SENTINEL)))

    return run


def dense_topk(hashsize: int, words: int, qp: int, k: int,
               packed_keys: bool = True):
    """counts + exact top-k for one index block.

    Returns a function of (Kbits (qp, hashsize/32) uint32, bits (hashsize,
    words) uint32, n_real) giving (counts (qp, k) int32, positions (qp, k)
    int32) in reference heap order; invalid rows carry count -1 and
    position 2^30 (the contract of score_mxu.dense_topk_kernel)."""
    n_cols = words * 32
    if k > n_cols:
        raise ValueError("k=%d exceeds the block's %d columns" % (k, n_cols))

    def run(Kbits: torch.Tensor, bits: torch.Tensor, n_real: int):
        if tuple(Kbits.shape) != (qp, (hashsize + 31) // 32) \
                or tuple(bits.shape) != (hashsize, words):
            raise ValueError("dense_topk geometry mismatch")
        if not packed_keys:
            counts = counts_or_keys(Kbits, bits, n_real, pack=False)
            col = torch.arange(n_cols, dtype=torch.int64,
                               device=counts.device)
            c64 = torch.where(col < n_real, counts.to(torch.int64),
                              torch.full_like(col, -1))
            v, _ = torch.topk(c64 * (1 << 32) + (0xFFFFFFFF - col), k,
                              dim=1)
            vals = (v >> 32).to(torch.int32)
            pos = (0xFFFFFFFF - (v & 0xFFFFFFFF)).to(torch.int32)
            return vals, torch.where(vals >= 0, pos,
                                     torch.full_like(pos, POS_SENTINEL))
        key = counts_or_keys(Kbits, bits, n_real, pack=True)
        v2, _ = torch.topk(key, k, dim=1)
        valid = v2 >= 0
        cnt = torch.where(valid, v2 >> POS_BITS, torch.full_like(v2, -1))
        pos = torch.where(valid,
                          ((1 << POS_BITS) - 1) - (v2 & ((1 << POS_BITS) - 1)),
                          torch.full_like(v2, POS_SENTINEL))
        return cnt, pos

    return run


def merge_blocks(outs, bases, k: int):
    """Exact k-way merge of per-block top-k results: positions are globally
    heap-ordered, so the order is (count desc, global position asc).
    Invalid rows (count -1) go to the back with the position sentinel."""
    vals = torch.cat([v for v, _ in outs], dim=1)
    gidx = torch.cat([i + b for (_, i), b in zip(outs, bases)], dim=1)
    gidx = torch.where(vals < 0, torch.full_like(gidx, POS_SENTINEL), gidx)
    key = vals.to(torch.int64) * (1 << 32) + (0xFFFFFFFF - gidx.to(torch.int64))
    v, _ = torch.topk(key, k, dim=1)
    return ((v >> 32).to(torch.int32),
            (0xFFFFFFFF - (v & 0xFFFFFFFF)).to(torch.int32))


def pack_query_bits(query_kmer_lists: List[np.ndarray], qp: int,
                    hashsize: int) -> np.ndarray:
    """(qp, hashsize/32) uint32 one-hot bit rows (native tier, with a numpy
    fallback)."""
    from .. import native
    qw = (hashsize + 31) // 32
    n = len(query_kmer_lists)
    if n == 0:
        return np.zeros((qp, qw), dtype=np.uint32)
    starts = np.zeros(n + 1, dtype=np.int64)
    starts[1:] = np.cumsum([kl.size for kl in query_kmer_lists])
    allk = np.ascontiguousarray(
        np.concatenate(query_kmer_lists) if starts[-1]
        else np.zeros(0, np.uint32), dtype=np.uint32)
    out = native.pack_query_bits(allk, starts, n, qw)
    if out is None:
        # numpy fallback (row-chunked bitwise_or.at)
        out = np.zeros((n, qw), dtype=np.uint32)
        for q, kl in enumerate(query_kmer_lists):
            np.bitwise_or.at(out[q], (kl >> 5).astype(np.int64),
                             np.uint32(1) << (kl & 31).astype(np.uint32))
    if n < qp:
        out = np.vstack([out, np.zeros((qp - n, qw), dtype=np.uint32)])
    return out

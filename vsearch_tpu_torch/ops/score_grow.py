"""Device k-mer scoring for GROWING indexes (greedy clustering).

Counterpart of vsearch_tpu/ops/score_grow.py's GrowingDeviceKmerIndex.
Clustering adds every new centroid to its index mid-run (reference
dbindex.cpp:121-148 add_sequence), so device positions are assigned in
insertion order and cannot be presorted in min-heap order as ops/score.py's
DeviceKmerIndex is.  This class keeps the packed-bit incidence matrix
over-allocated on the device and appends columns with a scatter per round,
while the heap ORDER travels separately as a per-position rank vector
maintained incrementally on the host:

    key(q, p) = counts(q, p) << RANK_BITS  |  (RANK_MAX - rank(p))

which makes torch.topk's descending order exactly the reference min-heap's
(count desc, length asc, seqno asc) total order (src/core/minheap.cpp:
111-146) for any insertion order.  Kernel K4 (ops/score_dense.py,
csrc/score_dense.cu) computes the counts and folds the key, over the
filled 4096-position blocks only (scan_words).

ShardedGrowingKmerIndex spreads the positions over the ranks of a process
group (parallel/mesh.py) and merges the ranks' top-k with one all-gather.

Exactness gates: counts fit the key (supports(): a query has at most
MAX_COUNT k-mers, else the caller scores on its host tier) and positions
fit the ranks (the constructor refuses a capacity above RANK_MAX).

reference: src/core/searchcore.cpp:260-340 (search_topscores) feeding
src/core/cluster.cpp:877-1030.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .score_dense import (MAX_COUNT, POS_SENTINEL, RANK_BITS, RANK_MAX,
                          dense_topk_ranked, pack_query_bits, ranked_keys)
from ..utils.maps import CHRMAP_4BIT


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _encode(seq: bytes, width: int) -> np.ndarray:
    """4-bit codes of the first ``width`` bases of seq."""
    return CHRMAP_4BIT[np.frombuffer(seq[:width], dtype=np.uint8)] \
        .astype(np.int8)


class GrowingDeviceKmerIndex:
    """Over-allocated packed-bit incidence matrix with scatter appends."""

    # queries per K4 launch
    CHUNK = 512

    def __init__(self, wordlength: int, capacity: int,
                 device: torch.device) -> None:
        self.device = torch.device(device)
        self.wordlength = wordlength
        self.hashsize = 1 << (2 * wordlength)
        # whole K4 blocks: one block covers 128 words, 4096 positions
        cap = _round_up(max(capacity, 1), 4096)
        if cap > RANK_MAX:
            raise ValueError("capacity exceeds rank budget")
        self.cap = cap
        self.words = cap // 32
        self.n = 0
        # (hashsize + 1, words) int32 bit matrix in the JAX package's layout
        # (its trailing row is the scan kernel's gather sentinel); K4 reads
        # the first hashsize rows.  Allocated on the device: occupied
        # entries arrive through the same scatter as appends.
        self.bits = torch.zeros((self.hashsize + 1, self.words),
                                dtype=torch.int32, device=self.device)
        self.lengths = np.zeros(cap, dtype=np.int64)
        self.seqnos = np.zeros(cap, dtype=np.int64)
        # positions sorted by (length, seqno): maintained incrementally
        self._order = np.zeros(0, dtype=np.int64)
        self._rank_dev = None          # uploaded lazily before a topk
        self._rank_dirty = True
        # device-resident padded sequence codes (attach_codes): enables
        # the prefetch alignment chained off the top-k output
        self.codes = None              # (cap, width) int8 device
        self.tlen_dev = None           # (cap,) int32 device
        self.codes_width = 0

    # -- growth ----------------------------------------------------------

    def append_round(self, entries: Sequence[Tuple[np.ndarray, int, int]]
                     ) -> bool:
        """Append (kmers, length, seqno) entries; False if capacity full
        (caller rebuilds with a larger capacity)."""
        if self.n + len(entries) > self.cap:
            return False
        rows_all = []
        pos_all = []
        p0 = self.n
        for kmers, length, seqno in entries:
            p = self.n
            if kmers.size:
                rows_all.append(kmers.astype(np.int32))
                pos_all.append(np.full(kmers.size, p, dtype=np.int32))
            self.lengths[p] = length
            self.seqnos[p] = seqno
            self.n += 1
        # batched sorted-order insert (length asc, seqno asc): composite
        # keys are unique (seqno disambiguates), so inserting the new
        # entries in key order at their searchsorted positions reproduces
        # the exact total order
        new_p = np.arange(p0, self.n, dtype=np.int64)
        new_key = self.lengths[new_p] * (1 << 40) + self.seqnos[new_p]
        ksort = np.argsort(new_key, kind="stable")
        composite = self.lengths[self._order] * (1 << 40) \
            + self.seqnos[self._order]
        at = np.searchsorted(composite, new_key[ksort])
        self._order = np.insert(self._order, at, new_p[ksort])
        if rows_all:
            self._scatter(np.concatenate(rows_all), np.concatenate(pos_all))
        if self.codes is not None and entries:
            self._append_codes(entries, p0)
        self._rank_dirty = True
        return True

    def _scatter(self, rows: np.ndarray, pos: np.ndarray) -> None:
        """Set bit pos of row ``rows`` for every (k-mer, position) pair, in
        one upload.  The targeted bits are fresh and every pair is unique,
        so an accumulating add equals an or; bit 31 adds INT32_MIN, which
        is its two's complement pattern."""
        vals = (np.uint32(1) << (pos & 31).astype(np.uint32)).view(np.int32)
        packed = torch.from_numpy(np.stack([rows, pos >> 5, vals])) \
            .to(self.device)
        self.bits.index_put_((packed[0].long(), packed[1].long()),
                             packed[2], accumulate=True)

    def attach_codes(self, width: int, seq_of) -> None:
        """Allocate the (cap, width) device code matrix and backfill the
        occupied positions.  seq_of: callable seqno -> sequence bytes
        (kept for appends)."""
        self.codes_width = width
        self._seq_of = seq_of
        codes = np.zeros((self.cap, width), dtype=np.int8)
        tlen = np.zeros(self.cap, dtype=np.int32)
        for p in range(self.n):
            c = _encode(seq_of(int(self.seqnos[p])), width)
            codes[p, :c.size] = c
            tlen[p] = c.size
        self.codes = torch.from_numpy(codes).to(self.device)
        self.tlen_dev = torch.from_numpy(tlen).to(self.device)

    def _append_codes(self, entries, p0: int) -> None:
        ne = len(entries)
        nc = np.zeros((ne, self.codes_width), dtype=np.int8)
        nl = np.zeros(ne, dtype=np.int32)
        for k, (_, _, seqno) in enumerate(entries):
            c = _encode(self._seq_of(seqno), self.codes_width)
            nc[k, :c.size] = c
            nl[k] = c.size
        self.codes[p0:p0 + ne] = torch.from_numpy(nc).to(self.device)
        self.tlen_dev[p0:p0 + ne] = torch.from_numpy(nl).to(self.device)

    @classmethod
    def build(cls, wordlength: int, kmer_lists: List[np.ndarray],
              lengths: Sequence[int], seqnos: Sequence[int],
              capacity: int, device: torch.device
              ) -> "GrowingDeviceKmerIndex":
        """Bulk build for activation or capacity growth: the occupied
        entries ship as ONE (k-mer, position) scatter into the zero matrix,
        so the upload scales with the data, not the capacity."""
        self = cls(wordlength, capacity, device)
        n = len(kmer_lists)
        if n:
            rows_all = [kl.astype(np.int32) for kl in kmer_lists if kl.size]
            pos_all = [np.full(kl.size, p, dtype=np.int32)
                       for p, kl in enumerate(kmer_lists) if kl.size]
            if rows_all:
                self._scatter(np.concatenate(rows_all),
                              np.concatenate(pos_all))
            self.lengths[:n] = np.asarray(lengths)
            self.seqnos[:n] = np.asarray(seqnos)
            self.n = n
            self._order = np.lexsort((self.seqnos[:n], self.lengths[:n]))
            self._rank_dirty = True
        return self

    # -- scoring ---------------------------------------------------------

    def _ranks(self) -> torch.Tensor:
        """(32*words,) int32 device heap rank of each position, RANK_MAX
        where the position is empty."""
        if self._rank_dirty or self._rank_dev is None:
            rank = np.full(self.cap, RANK_MAX, dtype=np.int32)
            rank[self._order] = np.arange(self.n, dtype=np.int32)
            self._rank_dev = torch.from_numpy(self._held(rank)).to(
                self.device)
            self._rank_dirty = False
        return self._rank_dev

    def _held(self, per_pos: np.ndarray) -> np.ndarray:
        """The entries of a per-position array for the positions this
        index holds on its device, in its column order: all of them."""
        return per_pos

    def scan_words(self) -> int:
        """Packed words a top-k scans: the whole 4096-position blocks that
        hold the n filled positions."""
        return _round_up(self.n, 4096) // 32

    def supports(self, kmer_lists: List[np.ndarray]) -> bool:
        return max((kl.size for kl in kmer_lists), default=0) <= MAX_COUNT

    def topk_dispatch(self, kmer_lists: List[np.ndarray], tophits: int):
        """Launch the ranked top-k without waiting for it; per-chunk (count,
        pos) device tensors let the cluster engine chain the prefetch
        alignment on the device before fetching anything."""
        q = len(kmer_lists)
        k = min(tophits, self.n)
        if q == 0 or self.n == 0 or k == 0:
            return (q, [])
        pending = []
        for lo in range(0, q, self.CHUNK):
            chunk = kmer_lists[lo:lo + self.CHUNK]
            qp = len(chunk)
            Kbits = torch.from_numpy(pack_query_bits(
                chunk, qp, self.hashsize).view(np.int32)).to(self.device)
            pending.append((qp, self._chunk_topk(Kbits, qp, k)))
        return (q, pending)

    def _chunk_topk(self, Kbits: torch.Tensor, qp: int, k: int):
        """(counts, positions) (qp, k) device tensors of one chunk.  Only
        the filled prefix is scanned: positions are assigned from 0 in
        insertion order, whole K4 blocks of 4096 cover the first n, and
        k <= n keeps every candidate there (empty positions key to -1).
        A view of bits' row prefixes: no copy."""
        used = self.scan_words()
        return dense_topk_ranked(self.hashsize, used, qp, k)(
            Kbits, self.bits[:self.hashsize, :used],
            self._ranks()[:used * 32])

    def topk_cut(self, fetched_pending,
                 minmatches_list: Sequence[int]
                 ) -> List[List[Tuple[int, int]]]:
        """Host cut of already-fetched chunk results into per-query
        (seqno, count) lists in reference heap order."""
        out: List[List[Tuple[int, int]]] = []
        qi_global = 0
        for nq, (vals, idx) in fetched_pending:
            vals = np.asarray(vals)
            idx = np.asarray(idx)
            for r in range(nq):
                mm = minmatches_list[qi_global]
                row: List[Tuple[int, int]] = []
                for c, p in zip(vals[r].tolist(), idx[r].tolist()):
                    if c < mm:
                        break
                    row.append((int(self.seqnos[p]), int(c)))
                out.append(row)
                qi_global += 1
        return out

    def topk_batch(self, kmer_lists: List[np.ndarray], tophits: int,
                   minmatches_list: Sequence[int]
                   ) -> List[List[Tuple[int, int]]]:
        """Per-query (seqno, count) candidates in reference heap order."""
        q, pending = self.topk_dispatch(kmer_lists, tophits)
        if not pending:
            return [[] for _ in range(q)]
        return self.topk_cut(
            [(nq, (v.cpu().numpy(), i.cpu().numpy()))
             for nq, (v, i) in pending], minmatches_list)


class ShardedGrowingKmerIndex(GrowingDeviceKmerIndex):
    """GrowingDeviceKmerIndex whose positions are sharded over the ranks of
    the process group (vsearch_tpu/ops/score_grow.py:524-570).

    Rank r holds the positions p with p % S == r, as its column p // S:
    positions are assigned in insertion order, so shards of contiguous
    positions would leave the upper ranks empty, and idle, until the
    lower ones filled, while interleaved ones fill together and each
    rank's filled prefix is a 1/S share.  An append lands only on the
    rank that owns its position (the owner-masked scatter of
    _sharded_scatter_fn, score_grow.py:414-441).  Each rank runs K4 over
    its filled blocks and a local top-k; the rank key is the reference
    heap's total order, so one all-gather and a top-k of the gathered
    keys are exact (score_grow.py:444-494).  The host bookkeeping
    (lengths, seqnos, heap ranks) is the single-device class's, over the
    global positions, and the sequence codes are replicated."""

    def __init__(self, wordlength: int, capacity: int,
                 device: torch.device) -> None:
        from ..parallel.mesh import active_mesh
        mesh = active_mesh()
        if mesh is None:
            raise RuntimeError("ShardedGrowingKmerIndex needs a process "
                               "group of more than one rank")
        self.mesh = mesh
        cap = _round_up(max(capacity, 1), 4096 * mesh.size)
        if cap > RANK_MAX:
            raise ValueError("capacity exceeds rank budget")
        # the device holds this rank's cap / S columns; the host arrays
        # cover every position
        super().__init__(wordlength, cap // mesh.size, device)
        self.cap = cap
        self.lengths = np.zeros(cap, dtype=np.int64)
        self.seqnos = np.zeros(cap, dtype=np.int64)

    def _scatter(self, rows: np.ndarray, pos: np.ndarray) -> None:
        mine = pos % self.mesh.size == self.mesh.rank
        super()._scatter(rows[mine], pos[mine] // self.mesh.size)

    def _held(self, per_pos: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(per_pos[self.mesh.rank::self.mesh.size])

    def scan_words(self) -> int:
        """The whole K4 blocks of this rank's filled columns."""
        n_local = max(0, -(-(self.n - self.mesh.rank) // self.mesh.size))
        return _round_up(n_local, 4096) // 32

    def _chunk_topk(self, Kbits: torch.Tensor, qp: int, k: int):
        """This rank's top-k (k keys, padded with -1 where it holds fewer
        filled columns), then the top-k of every rank's: the keys carry
        the global position in their low 32 bits."""
        used = self.scan_words()
        size, rank = self.mesh.size, self.mesh.rank
        key = torch.full((qp, k), -(1 << 32), dtype=torch.int64,
                         device=self.device)
        kk = min(k, used * 32)
        if kk:
            v, col = torch.topk(ranked_keys(
                Kbits, self.bits[:self.hashsize, :used],
                self._ranks()[:used * 32]), kk, dim=1)
            key[:, :kk] = (v.to(torch.int64) << 32) \
                | (col.to(torch.int64) * size + rank)
        top, _ = torch.topk(self.mesh.all_gather(key, 1), k, dim=1)
        v = (top >> 32).to(torch.int32)
        valid = v >= 0
        return (torch.where(valid, v >> RANK_BITS, torch.full_like(v, -1)),
                torch.where(valid, (top & 0xFFFFFFFF).to(torch.int32),
                            torch.full_like(v, POS_SENTINEL)))


def growing_index_class():
    """The growing index of this process: sharded over the ranks of a
    process group, else on the one device."""
    from ..parallel.mesh import active_mesh
    return (ShardedGrowingKmerIndex if active_mesh() is not None
            else GrowingDeviceKmerIndex)

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

from .score_dense import (MAX_COUNT, RANK_MAX, dense_topk_ranked,
                          pack_query_bits)
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
            rank = np.full(self.words * 32, RANK_MAX, dtype=np.int32)
            rank[self._order] = np.arange(self.n, dtype=np.int32)
            self._rank_dev = torch.from_numpy(rank).to(self.device)
            self._rank_dirty = False
        return self._rank_dev

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
        # only the filled prefix is scanned: positions are assigned from 0
        # in insertion order, whole K4 blocks of 4096 cover the first n,
        # and k <= n keeps every candidate there (empty positions key to
        # -1).  A view of bits' row prefixes: no copy.
        used = self.scan_words()
        rank = self._ranks()[:used * 32]
        bits = self.bits[:self.hashsize, :used]
        pending = []
        for lo in range(0, q, self.CHUNK):
            chunk = kmer_lists[lo:lo + self.CHUNK]
            qp = len(chunk)
            Kbits = torch.from_numpy(pack_query_bits(
                chunk, qp, self.hashsize).view(np.int32)).to(self.device)
            pending.append((qp, dense_topk_ranked(
                self.hashsize, used, qp, k)(Kbits, bits, rank)))
        return (q, pending)

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

"""Device k-mer candidate scoring.

The database k-mer incidence lives on the device as packed-bit blocks
(4^w x words uint32 per block of BLOCK_POS positions), and a query chunk's
shared-k-mer counts against each block come from kernel K1
(ops/score_dense.py).  Index positions are presorted by (length asc, seqno
asc), so the top-k order (count desc, position asc) IS the reference
min-heap's total order (count desc, length asc, seqno asc;
minheap.cpp:111-146).  Per-block top-k results merge exactly on the
device, and only (k) values + positions per query cross to the host.

Counterpart of vsearch_tpu/ops/score.py's DeviceKmerIndex on its dense
path; the same counts also serve the geometries the JAX package sent to
its scan kernel, so there is one scoring kernel.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .score_dense import (DENSE_MAXK_LIMIT, NBLK, dense_topk, merge_blocks,
                          pack_query_bits)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class DeviceKmerIndex:
    """Packed-bit incidence matrix on device, positions in heap order."""

    # device DB sequence storage is only built when the padded code matrix
    # stays within this budget (int8 bytes); beyond it the host-driven
    # alignment path carries the load
    DB_CODES_BUDGET = 4 << 30

    # positions per packed-bit block: bounds the (qp, 32*words) int32
    # counts of one dispatch; per-block top-k results merge exactly
    BLOCK_POS = 131072

    # queries per scoring dispatch
    CHUNK = 512

    def __init__(self, wordlength: int, kmer_lists: List[np.ndarray],
                 lengths: np.ndarray, mapping: np.ndarray,
                 device: torch.device) -> None:
        self.device = torch.device(device)
        self.wordlength = wordlength
        self.hashsize = 1 << (2 * wordlength)
        presorted = self._presort(kmer_lists, lengths, mapping)
        self.blocks = self._pack_blocks(presorted, 0, max(self.n, 1))
        self._init_codes()

    def _presort(self, kmer_lists: List[np.ndarray], lengths: np.ndarray,
                 mapping: np.ndarray):
        """Order positions as the reference heap does and concatenate their
        k-mers: sets n, perm, seqno_by_pos and length_by_pos, returns the
        (all_kmers, starts, sizes) that _pack_blocks packs."""
        n = len(kmer_lists)
        self.n = n
        lengths = np.asarray(lengths, dtype=np.int64)
        mapping = np.asarray(mapping, dtype=np.int64)
        # device position p <-> heap rank p: sorted by (length, seqno) so
        # that the top-k position tie-break reproduces minheap_compare
        perm = np.lexsort((mapping, lengths))
        sizes = np.fromiter((kmer_lists[orig].size for orig in perm),
                            dtype=np.int64, count=n)
        all_kmers = np.ascontiguousarray(np.concatenate(
            [kmer_lists[orig] for orig in perm]), dtype=np.uint32) \
            if n and sizes.sum() else np.zeros(0, dtype=np.uint32)
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts[1:])
        self.seqno_by_pos = mapping[perm]
        self.length_by_pos = lengths[perm]
        self.perm = perm
        return all_kmers, starts, sizes

    def _pack_blocks(self, presorted, lo: int, hi: int) -> list:
        """Packed-bit blocks of at most BLOCK_POS positions covering
        positions [lo, hi), each (bits_dev (V, words) int32, words, base,
        n_real): block positions past n stay empty."""
        all_kmers, starts, sizes = presorted
        n = self.n
        from .. import native
        blocks = []
        base = lo
        while True:
            nb = min(hi - base, self.BLOCK_POS)
            nb_real = max(0, min(n - base, nb))
            words = max(_round_up(max(nb, 1), NBLK) // 32, 640)
            bits = np.zeros((self.hashsize, words), dtype=np.uint32)
            if nb_real > 0:
                lo_k, hi_k = int(starts[base]), int(starts[base + nb_real])
                blk_kmers = np.ascontiguousarray(all_kmers[lo_k:hi_k])
                blk_starts = np.ascontiguousarray(
                    starts[base:base + nb_real + 1] - starts[base])
                if not native.pack_bits(blk_kmers, blk_starts, nb_real,
                                        words, bits):
                    self._pack_bits_numpy(
                        bits, blk_kmers, blk_starts,
                        sizes[base:base + nb_real], nb_real)
            blocks.append((self._to_device(bits), words, base, nb_real))
            base += nb
            if base >= hi:
                return blocks

    def _to_device(self, bits: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.require(
            bits, requirements=("C", "W")).view(np.int32)).to(self.device)

    def _init_codes(self) -> None:
        # device-resident padded sequence codes in position order (attached
        # by attach_db_codes); enables index-gather alignment dispatches that
        # upload only query codes + candidate positions
        self.db_codes: Optional[torch.Tensor] = None   # (n, width) int8
        self.tlen_by_pos_dev: Optional[torch.Tensor] = None
        self.db_codes_width = 0
        self._pos_of_seqno: Optional[dict] = None

    @classmethod
    def from_numpy(cls, wordlength: int, blocks, perm: np.ndarray,
                   seqno_by_pos: np.ndarray, length_by_pos: np.ndarray,
                   db_codes: Optional[np.ndarray] = None,
                   device: torch.device = torch.device("cpu")
                   ) -> "DeviceKmerIndex":
        """Rebuild an index from another index's state as numpy arrays:
        ``blocks`` holds (bits, words, base, n_real) per block, where bits
        has V rows or V+1 (a trailing gather-sentinel row, dropped here)."""
        self = cls.__new__(cls)
        self.device = torch.device(device)
        self.wordlength = wordlength
        self.hashsize = 1 << (2 * wordlength)
        self.n = len(seqno_by_pos)
        self.blocks = []
        for bits, words, base, n_real in blocks:
            bits = np.asarray(bits)[:self.hashsize]
            if bits.shape != (self.hashsize, words):
                raise ValueError("block bits shape %s != (%d, %d)"
                                 % (bits.shape, self.hashsize, words))
            self.blocks.append((self._to_device(bits), int(words), int(base),
                                int(n_real)))
        self.perm = np.asarray(perm)
        self.seqno_by_pos = np.asarray(seqno_by_pos, dtype=np.int64)
        self.length_by_pos = np.asarray(length_by_pos, dtype=np.int64)
        self._init_codes()
        if db_codes is not None:
            self._set_codes(np.asarray(db_codes, dtype=np.int8))
        return self

    def _set_codes(self, codes: np.ndarray) -> None:
        self.db_codes = torch.from_numpy(codes).to(self.device)
        self.tlen_by_pos_dev = torch.from_numpy(
            self.length_by_pos.astype(np.int32)).to(self.device)
        self.db_codes_width = codes.shape[1]
        self._pos_of_seqno = {int(s): p
                              for p, s in enumerate(self.seqno_by_pos)}

    def attach_db_codes(self, db, bucket_fn) -> bool:
        """Upload padded 4-bit codes of every DB sequence, position order.

        Returns False (and leaves the index without device sequences) when
        the padded matrix exceeds DB_CODES_BUDGET."""
        if self.db_codes is not None:
            return True
        if self.n == 0:
            return False
        maxlen = int(self.length_by_pos.max())
        width = bucket_fn(max(maxlen, 1))
        if self.n * width > self.DB_CODES_BUDGET:
            return False
        from ..utils.maps import CHRMAP_4BIT
        lens = self.length_by_pos.astype(np.int64)
        flat = b"".join(db.getsequence(int(s)) for s in self.seqno_by_pos)
        arr = CHRMAP_4BIT[np.frombuffer(flat, dtype=np.uint8)].astype(np.int8)
        codes = np.zeros((self.n, width), dtype=np.int8)
        codes[np.arange(width)[None, :] < lens[:, None]] = arr
        self._set_codes(codes)
        return True

    def _pack_bits_numpy(self, bits: np.ndarray, all_kmers: np.ndarray,
                         starts: np.ndarray, sizes: np.ndarray,
                         n: int) -> None:
        """Pure-numpy fallback for native.pack_bits: scatter a boolean
        (4^w, pos-chunk) slab and packbits along positions."""
        POS_CHUNK = 8192           # 0.5 GB slab at 4^8
        words = bits.shape[1]
        slab = np.zeros((self.hashsize, POS_CHUNK), dtype=bool)
        for base in range(0, n, POS_CHUNK):
            hi = min(base + POS_CHUNK, n)
            lo_k, hi_k = starts[base], starts[hi]
            rel = np.repeat(np.arange(base, hi, dtype=np.int64) - base,
                            sizes[base:hi])
            slab[:, :] = False
            slab[all_kmers[lo_k:hi_k].astype(np.int64), rel] = True
            # rows are contiguous along the pack axis; little-endian
            # bit+byte order makes byte i bits 8i..8i+7 == positions
            packed = np.packbits(slab, axis=1, bitorder="little")
            w0 = base // 32
            w1 = min(w0 + POS_CHUNK // 32, words)
            bits[:, w0:w1] = packed.view(np.uint32)[:, :w1 - w0]

    def topk(self, query_kmer_lists: List[np.ndarray],
             k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k candidates per query in reference heap order.

        Returns (counts (Q, k) int32, positions (Q, k) int32); positions
        >= n or with count below the caller's minmatches must be dropped.
        """
        return self.topk_collect(self.topk_dispatch(query_kmer_lists, k))

    def topk_dispatch(self, query_kmer_lists: List[np.ndarray], k: int):
        """Launch the scoring of every chunk without waiting for it;
        collect with topk_collect.  Returns (q, [(nq, (vals, idx))]) with
        device tensors, so callers overlap host work with the device."""
        q = len(query_kmer_lists)
        k = min(k, self.n)
        if q == 0 or self.n == 0 or k == 0:
            return (q, [])
        maxk = max((kl.size for kl in query_kmer_lists), default=1)
        maxk = max(_round_up(maxk, 640), 640)
        packed = maxk <= DENSE_MAXK_LIMIT
        chunks = [query_kmer_lists[lo:lo + self.CHUNK]
                  for lo in range(0, q, self.CHUNK)]
        return (q, [(len(c), self._chunk_topk(c, k, packed)) for c in chunks])

    def _chunk_topk(self, chunk: List[np.ndarray], k: int, packed: bool):
        """(vals, positions) (qp, k) device tensors of one chunk: K1 and
        top-k on each block, then the exact merge by global position."""
        qp = 128 if len(chunk) <= 128 else self.CHUNK
        Kbits = self._to_device(pack_query_bits(chunk, qp, self.hashsize))
        outs = []
        for bits, words, _, nb_real in self.blocks:
            fn = dense_topk(self.hashsize, words, qp, min(k, words * 32),
                            packed_keys=packed)
            outs.append(fn(Kbits, bits, nb_real))
        bases = [b for _, _, b, _ in self.blocks]
        if bases == [0]:
            return outs[0]
        return merge_blocks(outs, bases, k)

    def topk_collect(self, state) -> Tuple[np.ndarray, np.ndarray]:
        q, pending = state
        if not pending:
            return (np.zeros((q, 0), dtype=np.int32),
                    np.zeros((q, 0), dtype=np.int32))
        vals = np.concatenate([v[:nq].cpu().numpy()
                               for nq, (v, _) in pending])
        idx = np.concatenate([i[:nq].cpu().numpy()
                              for nq, (_, i) in pending])
        return vals, idx

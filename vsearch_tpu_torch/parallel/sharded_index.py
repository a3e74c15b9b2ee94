"""The static k-mer index sharded over the ranks of the process group.

Counterpart of vsearch_tpu/parallel/sharded_index.py.  The positions of
ops/score.DeviceKmerIndex (presorted in the reference min-heap order) are
split into S equal shards of C positions: rank r packs and holds only
positions [r*C, (r+1)*C), as DeviceKmerIndex's blocks of at most
BLOCK_POS positions (a shard past the last position is empty and still
scores, to -1 everywhere).  Per query chunk each rank scores its blocks
with K1 and merges them (ops/score_dense.py), then the ranks' local top-k
are all-gathered and merged by the same key, the collective analogue of
the reference's per-thread min-heaps (minheap.cpp:82-146).

Exactness: shard r's positions are global positions r*C + local, and the
merge key (count desc, global position asc) is the reference heap's total
order, so the sharded top-k equals the single-process one.

reference: searchcore.cpp search_topscores (:260-340) + minheap.cpp.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.score import DeviceKmerIndex, _round_up
from ..ops.score_dense import NBLK, POS_SENTINEL
from .mesh import active_mesh


class ShardedKmerIndex(DeviceKmerIndex):
    """DeviceKmerIndex whose positions are sharded over the ranks.  The
    same surface for core/search.py: n, seqno_by_pos, length_by_pos,
    topk / topk_dispatch / topk_collect, attach_db_codes (the padded DB
    codes are replicated on every rank, so the top-1 prefetch aligns
    pair-sharded, ops/nw_batch.gather_align)."""

    def __init__(self, wordlength: int, kmer_lists: List[np.ndarray],
                 lengths: np.ndarray, mapping: np.ndarray,
                 device: torch.device) -> None:
        mesh = active_mesh()
        if mesh is None:
            raise RuntimeError("ShardedKmerIndex needs a process group of "
                               "more than one rank")
        self.mesh = mesh
        self.device = torch.device(device)
        self.wordlength = wordlength
        self.hashsize = 1 << (2 * wordlength)
        presorted = self._presort(kmer_lists, lengths, mapping)
        self.cols_per_shard = _round_up(-(-max(self.n, 1) // mesh.size),
                                        NBLK)
        lo = mesh.rank * self.cols_per_shard
        self.blocks = self._pack_blocks(presorted, lo,
                                        lo + self.cols_per_shard)
        self._init_codes()

    def _chunk_topk(self, chunk: List[np.ndarray], k: int, packed: bool):
        """This rank's top-k of one chunk over its blocks, then the ranks'
        merge: the gathered (qp, S*k_local) keys hold every rank's
        candidates, an invalid one (count -1) at the position sentinel."""
        cols = sum(words * 32 for _, words, _, _ in self.blocks)
        vals, pos = super()._chunk_topk(chunk, min(k, cols), packed)
        key = vals.to(torch.int64) * (1 << 32) \
            + (0xFFFFFFFF - pos.to(torch.int64))
        v, _ = torch.topk(self.mesh.all_gather(key, 1), k, dim=1)
        vals = (v >> 32).to(torch.int32)
        pos = (0xFFFFFFFF - (v & 0xFFFFFFFF)).to(torch.int32)
        return vals, torch.where(vals >= 0, pos,
                                 torch.full_like(pos, POS_SENTINEL))

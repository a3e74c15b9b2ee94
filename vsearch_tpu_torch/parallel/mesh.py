"""The ranks of the process group as one 1-D mesh, and its collectives.

Counterpart of vsearch_tpu/parallel/mesh.py.  The JAX package shards over
a mesh of every visible device (one process) or of every process's
devices (jax.distributed); in the port both are the process group, one
rank a shard, its world size the shard count (parallel/distributed.py).

* The static k-mer index is sharded along its position axis: each rank
  counts shared k-mers against its positions, takes a local top-k, and the
  ranks' candidates are all-gathered and merged exactly
  (parallel/sharded_index.py; the growing index's form is
  ops/score_grow.ShardedGrowingKmerIndex).
* Alignment is data-parallel over pairs: each rank aligns its slice of a
  batch's rows and the results are all-gathered (ops/nw_batch.py).

``COLLECTIVES`` counts the calls of each collective helper, as
ops/cuda_lib.LAUNCHES counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

COLLECTIVES: Dict[str, int] = {"all_gather": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


class Mesh:
    """The process group as a 1-D mesh: ``size`` ranks, this one ``rank``,
    its tensors on ``device``."""

    def __init__(self, device: torch.device) -> None:
        import torch.distributed as dist
        # the default group, which the collectives take: holding it here
        # would keep it, and its worker threads, past
        # distributed.shutdown
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = device

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in
        rank order, on every rank.  Gathered as bytes: gloo takes no int16
        or bool."""
        import torch.distributed as dist
        COLLECTIVES["all_gather"] += 1
        x = t.movedim(dim, 0).contiguous()
        raw = x.reshape(x.shape[0], math.prod(x.shape[1:])).view(
            torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(self.size)]
        dist.all_gather(parts, raw)
        out = torch.cat(parts).view(x.dtype).reshape(
            (x.shape[0] * self.size,) + tuple(x.shape[1:]))
        return out.movedim(0, dim)

    def rows(self, n: int) -> Optional[Tuple[int, int]]:
        """This rank's slice [lo, hi) of a batch of n rows when the ranks
        split it evenly, else None (every rank then runs the whole
        batch)."""
        if n % self.size:
            return None
        part = n // self.size
        return self.rank * part, (self.rank + 1) * part


_ACTIVE: Optional[Mesh] = None


def active_mesh() -> Optional[Mesh]:
    """The mesh over the process group's ranks, or None without a group of
    more than one rank (the single-process path)."""
    global _ACTIVE
    from .distributed import rank_device
    dev = rank_device()
    if dev is None:
        return None
    if _ACTIVE is None:
        _ACTIVE = Mesh(dev)
    return _ACTIVE


def sharded_count_topk(mesh: Optional[Mesh], A: torch.Tensor,
                       bits_shard: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The multi-chip dry run's count step (mesh.py:68-113): A (Q,
    hashsize) int8 replicated, bits_shard (hashsize, words) this rank's
    packed positions (uint32 or int32).  Each rank counts its positions
    with a plain product, takes its top-k in the exact order (count desc,
    position asc) and the ranks' candidates are all-gathered: (Q, S*k)
    counts and global positions, rank-major.  Without a mesh, one shard."""
    size, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    bits = bits_shard.view(torch.int32) if bits_shard.dtype == torch.uint32 \
        else bits_shard
    cols = bits.shape[1] * 32
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    unpacked = ((bits[:, :, None] >> shifts) & 1).reshape(bits.shape[0],
                                                          cols)
    counts = A.to(torch.int64) @ unpacked.to(torch.int64)
    col = torch.arange(cols, dtype=torch.int64, device=bits.device)
    v, _ = torch.topk(counts * (1 << 32) + (0xFFFFFFFF - col), k, dim=1)
    top_counts = (v >> 32).to(torch.int32)
    top_idx = (0xFFFFFFFF - (v & 0xFFFFFFFF) + rank * cols).to(torch.int32)
    if size == 1:
        return top_counts, top_idx
    return mesh.all_gather(top_counts, 1), mesh.all_gather(top_idx, 1)


def sharded_nw_scores(mesh: Optional[Mesh], scheme_key: tuple, qmT, amT,
                      qlen, t4T, tlen) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dry run's pair-parallel forward scores (mesh.py:116-139) on the
    row wire of ops/nw_batch.encode_rowT: each rank runs the K2 forward on
    its slice of the batch's pairs and the (B,) scores and overflow flags
    are all-gathered.  Without a mesh, or with a batch the ranks do not
    split evenly, the whole batch runs here."""
    from ..ops.nw_rowscan import build_forward
    forward = build_forward(scheme_key)
    rows = mesh.rows(qmT.shape[1]) if mesh is not None else None
    if rows is None:
        score, overflow, _ = forward(qmT, amT, qlen, t4T, tlen)
        return score, overflow
    lo, hi = rows
    score, overflow, _ = forward(
        qmT[:, lo:hi].contiguous(), amT[:, lo:hi].contiguous(), qlen[lo:hi],
        t4T[:, lo:hi].contiguous(), tlen[lo:hi])
    return mesh.all_gather(score), mesh.all_gather(overflow)

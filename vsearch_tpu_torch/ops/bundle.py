"""Device-to-host fetch of results without a wait at dispatch time.

Counterpart of vsearch_tpu/ops/bundle.py.  ``fetch_start`` copies every
CUDA tensor of a tree of results into pinned host buffers without
waiting, queued behind the launches that make them, and records one CUDA
event behind the copies, so the transfers overlap the host's work until
``fetch_wait`` waits on that event alone and views the copies as numpy
arrays.  On the CPU device the results already lie on the host and are
only viewed.  The batched aligner (ops/nw_batch.py) and the allpairs
pipeline (ops/allpairs_dev.py) fetch through them; ``bundle_fetch`` and
``unbundle_fetch`` fetch a search batch's, a clustering round's or a
chimera round's per-chunk results (core/search.py, core/cluster.py,
core/chimera.py).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import torch

from ..utils.phasetimer import phase


def _tree_map(fn, tree):
    """fn applied to every tensor of ``tree``: a tensor, None, or a tuple,
    list or dict of trees."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _tree_map(fn, x) for key, x in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return fn(tree)


def fetch_start(tensors):
    """A handle for fetch_wait: every CUDA tensor of ``tensors`` (a tree
    as _tree_map takes it) copied to pinned host memory without waiting,
    and one event recorded after the copies (None where every tensor
    already lies on the host)."""
    on_card = False

    def start(t: torch.Tensor) -> torch.Tensor:
        nonlocal on_card
        if not t.is_cuda:
            return t
        on_card = True
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    copies = _tree_map(start, tensors)
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record()
    return copies, event


def fetch_wait(handle, span: Optional[str] = None):
    """fetch_start's tensors as numpy arrays, in the tree it was given,
    once its event has passed (that event alone: work queued after the
    copies runs on); the wait is the phase ``span``, where one is
    named."""
    copies, event = handle
    if event is not None:
        with phase(span) if span else nullcontext():
            event.synchronize()
    return _tree_map(lambda t: t.numpy(), copies)


def bundle_fetch(chunks, prefetch):
    """chunks: [(nq, (vals, idx))] per-chunk top-k tensors; prefetch: a
    parallel list (or None) of per-chunk prefetch results: None, a top-1
    (score, overflow, ops) triple (the search path) or a compact
    {"mat": meta, "ops": ops} dict (the clustering round,
    nw_batch.compact_gather).  Returns an opaque handle for
    unbundle_fetch."""
    return fetch_start(([topk for _, topk in chunks],
                        list(prefetch or [None] * len(chunks))))


def unbundle_fetch(bundled):
    """Wait for the copies; return (topk_h, pref_h) as numpy arrays: a list
    of (vals, idx) and, per chunk, the prefetch result in the form it was
    given (None, a triple or a dict)."""
    return fetch_wait(bundled)

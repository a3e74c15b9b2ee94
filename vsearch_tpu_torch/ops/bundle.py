"""Device-to-host fetch of a search batch's or a clustering round's
results.

Counterpart of vsearch_tpu/ops/bundle.py.  ``bundle_fetch`` starts, at
dispatch time, one non-blocking copy of every per-chunk result (top-k
values and positions, and the prefetch's tensors) into pinned host
buffers and records one CUDA event behind them, so the transfers overlap
the previous batch's host work.  ``unbundle_fetch`` waits on that event
and returns the (topk_h, pref_h) pair that core/search.py and
core/cluster.py consume.  On the CPU device the results already lie on
the host and are only viewed as numpy arrays.
"""

from __future__ import annotations

import torch


def _map_pref(fn, p):
    """fn applied to every tensor of one chunk's prefetch result: None, a
    tuple, or a dict."""
    if p is None:
        return None
    if isinstance(p, dict):
        return {key: fn(x) for key, x in p.items()}
    return tuple(fn(x) for x in p)


def bundle_fetch(chunks, prefetch):
    """chunks: [(nq, (vals, idx))] per-chunk top-k tensors; prefetch: a
    parallel list (or None) of per-chunk prefetch results: None, a top-1
    (score, overflow, ops) triple (the search path) or a compact
    {"mat": meta, "ops": ops} dict (the clustering round,
    nw_batch.compact_gather).  Returns an opaque handle for
    unbundle_fetch."""
    event = None

    def start(t: torch.Tensor) -> torch.Tensor:
        if not t.is_cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    topk = [(start(v), start(i)) for _, (v, i) in chunks]
    pref = [_map_pref(start, p) for p in (prefetch or [None] * len(chunks))]
    if any(v.is_cuda for _, (v, _) in chunks):
        event = torch.cuda.Event()
        event.record()
    return topk, pref, event


def unbundle_fetch(bundled):
    """Wait for the copies; return (topk_h, pref_h) as numpy arrays: a list
    of (vals, idx) and, per chunk, the prefetch result in the form it was
    given (None, a triple or a dict)."""
    topk, pref, event = bundled
    if event is not None:
        event.synchronize()
    topk_h = [(v.numpy(), i.numpy()) for v, i in topk]
    return topk_h, [_map_pref(lambda x: x.numpy(), p) for p in pref]

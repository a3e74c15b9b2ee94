"""Host milliseconds of the search front a thousand reads: the program's
phase timers prep + dispatch + topk_fetch + prefetch + emit
(core/search.py SearchContext, commands/usearch_global.py).  Layer:
search, front.  Moves queries_per_s."""

from benchmark.metrics import _common

PHASES = ("prep", "dispatch", "topk_fetch", "prefetch", "emit")


def read(ctx):
    return _common.ms_per(ctx, _common.phases(ctx, PHASES), 1e3)

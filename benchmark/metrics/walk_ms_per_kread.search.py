"""Host milliseconds of the search walk a thousand reads: the program's
phase timer ``walk`` (core/search.py _run_walks, which holds ``align``:
BatchAligner's rounds and their host assembly).  Layer: search,
walk.  Moves queries_per_s."""

from benchmark.metrics import _common


def read(ctx):
    return _common.ms_per(ctx, _common.phases(ctx, ("walk",)), 1e3)

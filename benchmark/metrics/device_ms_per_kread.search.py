"""Device busy milliseconds a thousand reads in the traced search window
(the union of the profiler's device intervals): K1, top-k, K2, K3 and
their copies.  Layer: kernels.  Moves queries_per_s."""

from benchmark.metrics import _common


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    return _common.ms_per(ctx, ctx.trace.busy_s, 1e3)

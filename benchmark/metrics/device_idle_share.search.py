"""Share of the traced search window in which nothing ran on the card
(1 - the union of the profiler's device intervals / the window).
Layer: device.  Moves queries_per_s."""

from benchmark.metrics import _common


def read(ctx):
    return _common.idle_share(ctx)

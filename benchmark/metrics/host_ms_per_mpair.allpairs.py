"""Host milliseconds of the allpairs command a million pairs: the
program's phase timers stats_fetch + accept + align + emit
(commands/allpairs.py, ops/allpairs_dev.py).  ``dispatch``, which waits
behind K2m, is left out.  Layer: CLI allpairs.  Moves pairs_per_s."""

from benchmark.metrics import _common

PHASES = ("stats_fetch", "accept", "align", "emit")


def read(ctx):
    return _common.ms_per(ctx, _common.phases(ctx, PHASES), 1e6)

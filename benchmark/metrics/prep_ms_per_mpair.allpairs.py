"""Host milliseconds a million pairs of the allpairs command's work before
its first batch is queued, with the card idle: the self time of the
program's spans read + mask + context + upload + triangle
(commands/allpairs.py).  Layer: CLI allpairs.  Moves pairs_per_s."""

from benchmark.metrics import _common, _spans

SPANS = ("read", "mask", "context", "upload", "triangle")


def read(ctx):
    return _common.ms_per(ctx, _spans.self_time(SPANS), 1e6)

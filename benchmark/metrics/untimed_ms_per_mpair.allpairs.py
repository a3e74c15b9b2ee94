"""Host milliseconds a million pairs of the allpairs jobs that no span of
the program explains: the self time of its root span ``cli`` (the whole
of cli.main).  Layer: CLI allpairs.  Moves pairs_per_s."""

from benchmark.metrics import _common, _spans


def read(ctx):
    return _common.ms_per(ctx, _spans.self_time(("cli",)), 1e6)

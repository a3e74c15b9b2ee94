"""Host microseconds a hit written by the allpairs command: the self time
of the program's span ``emit`` (the hits rebuilt and written to every
output file) over its counter ``allpairs.rows``.  Layer: CLI allpairs.
Moves pairs_per_s."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.per(_spans.self_time(("emit",)),
                      _spans.count("allpairs.rows"), 1e6)

"""Host microseconds a realigned pair of the allpairs command: the self
time of the program's span ``align`` (SearchContext.align_pairs, less
``align_wait``, the fetch that waits on K2 + K3) over its counter
``allpairs.realigned`` (overflow and accepted pairs).  Layer: CLI
allpairs.  Moves pairs_per_s."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.per(_spans.self_time(("align",)),
                      _spans.count("allpairs.realigned"), 1e6)

"""Share of the allpairs DP's roofline: the least time the card could
take for the DP work of the traced window's jobs, over the card's busy
time in that window (all kernels, so a renamed kernel cannot make it
read 0).  Layer: kernels (csrc/nw_rowscan.cu K2m, csrc/nw_stats.cu K5).
Moves pairs_per_s.

The work is the function's, fixed here, not today's kernels':

* Operations: pairs x query length x target length x OPS_PER_CELL.  One
  cell of the affine-gap update with vsearch's tie rules and its match
  count needs 16 integer operations:
    E' = max(E - ext, H - open)                         3
    F' = max(F - ext, H - open)                         3
    H  = max(Hdiag + s(q, t), E, F), s by one compare   4
    the four direction comparisons of the tie rules
    (F > H, E > H, E - ext > H - open, F - ext > H - open) 4
    the match indicator and its fold into the cell      2
* Rate: peaks.int_ops_per_s: 128 lanes x SMs x maximum SM clock, read
  from the card; twice that where every value fits 16 bits: a path's
  score moves by at most max(|match|, |mismatch|, gap penalties) a
  step, over at most m + n steps.
* Bytes: the set's codes read once and each pair's 9 stats words (int32)
  written once, over the HBM rate.
* Share, in %: the larger of the two bounds over the busy time.
"""

import math

from benchmark.harness import peaks

OPS_PER_CELL = 16
STATS_BYTES = 9 * 4


def fits16(cfg) -> bool:
    s = cfg["reference"]["scheme"]
    step = max(abs(int(v)) for v in s.values())
    length = int(cfg["generator"]["length"])
    return step * 2 * length <= 32767


def read(ctx):
    if not ctx.dp_cells or ctx.clock_hz is None or ctx.trace.busy_s <= 0:
        return None
    gen = ctx.config["generator"]
    n, length = math.prod(gen["branching"]), int(gen["length"])
    ops = ctx.dp_cells * OPS_PER_CELL
    nbytes = ctx.jobs * n * length + ctx.work * STATS_BYTES
    rate = peaks.int_ops_per_s(ctx.sms, ctx.clock_hz, fits16(ctx.config))
    return 100.0 * peaks.least_seconds(ops, nbytes, rate) / ctx.trace.busy_s

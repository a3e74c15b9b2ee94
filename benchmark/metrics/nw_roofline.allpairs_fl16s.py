"""Share of the full-length allpairs DP's roofline: the least time the
card could take for the DP work of the traced window's jobs, over the
card's busy time in that window (all kernels, so a renamed kernel cannot
make it read 0).  Layer: kernels (csrc/nw_rowscan.cu K2m, csrc/nw_stats.cu
K5).  Moves pairs_per_s.

The work is nw_roofline.allpairs's: pairs x query length x target length
x 16 integer operations a cell, the set's codes read once and each pair's
9 stats words written once.  What differs is the rule for two operations
a lane: every value of the function must fit 16 bits by the path-score
envelope of the scheme at these lengths, written here:

    hlo = min(m, n) * min(match, mismatch, 0) - 2 * max(open)
          - max(m, n) * max(ext)
    hhi = min(m, n) * max(match, 0)

(every path score to a cell of the m x n box, and every boundary value,
lies in [hlo, hhi]).  At 1450 nt under vsearch's default scheme it is
[-8740, 2900]: 16 bits, where "largest step x (m + n)" (58 000) would not
be.
"""

import math

from benchmark.harness import peaks

OPS_PER_CELL = 16
STATS_BYTES = 9 * 4


def envelope(scheme: dict, m: int, n: int):
    """(hlo, hhi) of the path scores in the m x n box."""
    opens = (int(scheme["open_int"]), int(scheme["open_end"]))
    exts = (int(scheme["ext_int"]), int(scheme["ext_end"]))
    match, mismatch = int(scheme["match"]), int(scheme["mismatch"])
    hlo = (min(m, n) * min(match, mismatch, 0) - 2 * max(opens)
           - max(m, n) * max(exts))
    return hlo, min(m, n) * max(match, 0)


def fits16(cfg) -> bool:
    length = int(cfg["generator"]["length"])
    hlo, hhi = envelope(cfg["reference"]["scheme"], length, length)
    return -32768 <= hlo and hhi <= 32767


def read(ctx):
    if not ctx.dp_cells or ctx.clock_hz is None or ctx.trace.busy_s <= 0:
        return None
    gen = ctx.config["generator"]
    n, length = math.prod(gen["branching"]), int(gen["length"])
    ops = ctx.dp_cells * OPS_PER_CELL
    nbytes = ctx.jobs * n * length + ctx.work * STATS_BYTES
    rate = peaks.int_ops_per_s(ctx.sms, ctx.clock_hz, fits16(ctx.config))
    return 100.0 * peaks.least_seconds(ops, nbytes, rate) / ctx.trace.busy_s

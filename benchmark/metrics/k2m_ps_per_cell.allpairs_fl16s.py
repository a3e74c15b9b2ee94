"""Picoseconds of the card a DP cell of allpairs' K2m: the device time of
the kernels whose names hold ``nw_rowscan`` in the traced window, over
the program's counter ``allpairs.cells`` (ops/allpairs_dev.py
AllPairsDevice.run: W * W cells a pair, padding included).  Layer:
kernels (csrc/nw_rowscan.cu).  Moves pairs_per_s.

The numerator also holds the realign's K2 (``nw_rowscan_kernel``), whose
cells the counter does not count: about 1600 pairs a job at the 1536
bucket, under 1 % of K2m's time in this cell.  A program without the
counter, or a window without the kernels, gives None.
"""

from benchmark.metrics import _spans


def read(ctx):
    seconds = sum(s for name, s in ctx.trace.kernel_s.items()
                  if "nw_rowscan" in name)
    if seconds <= 0:
        return None
    return _spans.per(seconds, _spans.count("allpairs.cells"), 1e12)

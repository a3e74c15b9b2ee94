"""Opt-in wall-clock phase accumulators for the search pipeline.

Enabled with VSEARCH_TPU_PHASES=1 (bench.py sets it for its breakdown
report); disabled, the context manager is a no-op with one dict lookup.

Phases instrumented in the usearch_global pipeline:
  load       db read + index build + device upload
  prep       query batch host prep (masking, unique-kmer extraction)
  dispatch   device top-k + top-1 prefetch dispatch (async, host side)
  topk_fetch bundled device->host fetch wait (top-k + prefetch rows)
  prefetch   prefetch table assembly (native CIGAR batch)
  align      alignment rounds (device NW + host assembly + linmem)
  walk       accept/reject replay walks (host)
  emit       hit joining + output writing

and in the clustering rounds (core/cluster.py), where walk also holds the
prefetch assembly and align nests inside walk and resolve:
  prep       round k-mer extraction
  dispatch   K4 top-k + compacted prefetch dispatch (device tier)
  host_topk  candidate counting on the host tier
  topk_fetch, prefetch, walk, align  as above
  resolve    serial resolution with the same-round repair

and in chimera detection (core/chimera.py, commands/chimera.py), where
align nests inside walk and resolve:
  load       db read, masking and abundance sort, the search context
  prep       round part and full-query k-mer extraction
  dispatch   K4 top-k dispatch of the round's parts (growing index)
  host_topk  part candidates on the host tier or the static index (K1)
  topk_fetch, walk, align  as above
  topk_cut   the fetched top-k cut into candidate lists
  tracker    the same-round repair index over the round's parts
  resolve    serial resolution, outputs and index growth
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

ENABLED = os.environ.get("VSEARCH_TPU_PHASES", "0") == "1"
acc: dict = defaultdict(float)
counts: dict = defaultdict(int)


@contextmanager
def phase(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        acc[name] += time.perf_counter() - t0
        counts[name] += 1


def reset() -> None:
    acc.clear()
    counts.clear()


def report() -> str:
    total = sum(acc.values())
    lines = ["phase breakdown (%.3fs instrumented):" % total]
    for name, t in sorted(acc.items(), key=lambda kv: -kv[1]):
        lines.append("  %-11s %7.3fs (%4.1f%%, n=%d)"
                     % (name, t, 100.0 * t / total if total else 0.0,
                        counts[name]))
    return "\n".join(lines)

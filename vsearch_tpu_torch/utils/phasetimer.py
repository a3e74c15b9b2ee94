"""Opt-in host spans and counters of the program's phases.

Enabled with VSEARCH_TPU_PHASES=1, or by setting ``ENABLED`` in process
(the benchmark's ``--trace 1`` window, chip_smoke.py); disabled, ``phase``
and ``add`` cost one flag test and record nothing.

A span, ``with phase(name)``, does three things when enabled:

* opens ``record_function("vs." + name)`` for its duration, so that under
  torch.profiler it is a host range on the timeline of the device's
  kernels, nested in whatever range holds it (the benchmark labels each
  idle gap of the device with the innermost range that holds it);
* adds its duration to ``acc[name]``: inclusive time, children and all;
* adds its self time, the duration less the time of the spans opened
  inside it on the same thread, to ``self_acc[name]``.

``add(name, n)`` adds n to ``tally[name]``, at the boundary where the
work happens.  ``reset()`` clears all three.  The spans themselves are
not kept: the profiler keeps them and writes them out with its trace.

Spans of every command:
  cli        the whole of cli.main; its self time is the job's host time
             that no other span explains

Spans and counters of allpairs_global (commands/allpairs.py,
ops/allpairs_dev.py), in job order:
  read       the FASTA read
  mask       dust_all / hardmask_all
  context    SearchContext.build
  upload     AllPairsDevice: the codes encoded and copied to the device
  triangle   the pair schedule (qpos, tpos)
  dispatch   K2m + K5 queued batch by batch (waits behind K2m)
  stats_fetch the stats copied to the host; holds stats_wait, the wait
             for the card to finish the triangle
  accept     the vectorised accept mask over the triangle
  collect    the accepted pairs by query, the overflow and realign lists;
             holds the overflow pairs' align
  align      SearchContext.align_pairs: the realign of the overflow and
             the accepted pairs; holds align_wait (ops/nw_batch.py
             BatchAligner._collect), the fetch that waits on K2 + K3
  emit       the hits rebuilt and written
  close      the output files flushed and closed
  allpairs.pairs      pairs through K2m + K5 (AllPairsDevice.run)
  allpairs.batches    the batches they are cut into
  allpairs.overflow   pairs whose scores overflowed
  allpairs.accepted   pairs the stats accept
  allpairs.realigned  pairs aligned again (overflow + accepted)
  allpairs.rows       hits written, once each whatever the output files

Metrics of the benchmark that read them (benchmark/metrics/):
  host_ms_per_mpair.allpairs     acc: stats_fetch + accept + align + emit
  prep_ms_per_mpair.allpairs     self_acc: read + mask + context + upload
                                 + triangle, a million pairs
  realign_us_per_pair.allpairs   self_acc align / allpairs.realigned
  emit_us_per_row.allpairs       self_acc emit / allpairs.rows
  untimed_ms_per_mpair.allpairs  self_acc cli, a million pairs
  walk_ms_per_kread.search, front_ms_per_kread.search  acc of the search
                                 phases below

Spans of the usearch_global pipeline:
  load       db read + index build + device upload
  prep       query batch host prep (masking, unique-kmer extraction)
  dispatch   device top-k + top-1 prefetch dispatch (async, host side)
  topk_fetch bundled device->host fetch wait (top-k + prefetch rows)
  prefetch   prefetch table assembly (native CIGAR batch)
  align      alignment rounds (device NW + host assembly + linmem);
             holds align_wait
  walk       accept/reject replay walks (host); holds align
  emit       hit joining + output writing

of the clustering rounds (core/cluster.py), where walk also holds the
prefetch assembly and align nests inside walk and resolve:
  prep       round k-mer extraction
  dispatch   K4 top-k + compacted prefetch dispatch (device tier)
  host_topk  candidate counting on the host tier
  topk_fetch, prefetch, walk, align  as above
  resolve    serial resolution with the same-round repair

and of chimera detection (core/chimera.py, commands/chimera.py), where
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
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

from torch.autograd.profiler import record_function

ENABLED = os.environ.get("VSEARCH_TPU_PHASES", "0") == "1"
acc: dict = defaultdict(float)
self_acc: dict = defaultdict(float)
tally: dict = defaultdict(int)

# per thread, the open spans, innermost last
_open = threading.local()


class _Span:
    __slots__ = ("child_s",)

    def __init__(self) -> None:
        self.child_s = 0.0


@contextmanager
def phase(name: str):
    if not ENABLED:
        yield
        return
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    span = _Span()
    with record_function("vs." + name):
        stack.append(span)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            acc[name] += dt
            self_acc[name] += dt - span.child_s
            if stack:
                stack[-1].child_s += dt


def add(name: str, n: int) -> None:
    if ENABLED:
        tally[name] += n


def reset() -> None:
    acc.clear()
    self_acc.clear()
    tally.clear()

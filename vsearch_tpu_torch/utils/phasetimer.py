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
  triangle   the pair schedule (qpos, tpos), and its copy to the device
  The triangle runs in chunks of batches (AllPairsDevice.chunks), two
  queued ahead of the one taken, so the spans from dispatch to emit
  repeat once a chunk (stats_fetch and align twice):
  dispatch   a chunk's K2m + K5 queued batch by batch; holds planes, the
             allocation of the plane buffers (once a run)
  accept     a chunk's accept cascade queued on the device
  stats_fetch a chunk's accept verdict and overflow flags (a byte each a
             pair) queued for copy to the host, and, two chunks later,
             their rows taken; holds stats_wait, the wait for the card to
             finish that chunk
  collect    a chunk's accepted pairs by query and its realign list, and,
             a chunk later, its overflow pairs' decision
  align      SearchContext.align_pairs_begin: a chunk's overflow and
             accepted pairs queued for their realign behind the next
             chunk, and align_pairs_end, once the chunk after that is
             queued: their results, holding align_wait (ops/nw_batch.py
             BatchAligner.align_pairs_end), the wait for K2 + K3 and
             their copy
  emit       the hits rebuilt and written, of the queries whose pairs the
             chunks realigned so far hold
  close      the output files flushed and closed
  allpairs.pairs      pairs through K2m + K5 (AllPairsDevice.run)
  allpairs.batches    the batches they are cut into
  allpairs.chunks     the chunks of batches the triangle runs in (1: no
                      overlap of the host's work with the card's)
  allpairs.cells      the DP cells K2m computes, W * W a pair (W the
                      run's padded width)
  allpairs.plane_bytes  bytes of the plane buffers allocated for the runs
  allpairs.overflow   pairs whose scores overflowed
  allpairs.accepted   pairs the stats accept
  allpairs.realigned  pairs whose index crosses to the host, to be
                      aligned again (overflow + accepted)
  allpairs.rows       hits written, once each whatever the output files

Metrics of the benchmark that read them (benchmark/metrics/):
  host_ms_per_mpair.allpairs     acc: stats_fetch + accept + align + emit
  prep_ms_per_mpair.allpairs     self_acc: read + mask + context + upload
                                 + triangle, a million pairs
  realign_us_per_pair.allpairs   self_acc align / allpairs.realigned
  emit_us_per_row.allpairs       self_acc emit / allpairs.rows
  untimed_ms_per_mpair.allpairs  self_acc cli, a million pairs
  k2m_ps_per_cell.allpairs_fl16s the device time of the nw_rowscan
                                 kernels / allpairs.cells
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

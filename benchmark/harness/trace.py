"""What a torch.profiler trace of the window says.

``busy_s`` is the length of the union of the intervals in which an
operation (kernel, copy or set) ran on the card, inside the window's own
host range; the idle share is 1 - busy_s / window_s (the arithmetic of
chip_smoke.py's trace()).  ``kernel_s`` sums each operation's time by
name.  An idle gap is a stretch of the window in which nothing ran on the
card; it is labelled by the innermost host-side event (a torch op or the
benchmark's own record_function ranges) that holds its midpoint.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW_RANGE = "bench.window"


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]
    idle_by_label: Dict[str, float]

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps[:top]]}


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(device_spans: List[Tuple[int, int, str]],
              host_spans: List[Tuple[int, int, str]],
              window: Tuple[int, int]) -> Summary:
    """Spans are (start_ns, end_ns, name) on one clock; window the host
    range of the measured window."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in device_spans
               if e > w0 and s < w1]
    kernel_s: Dict[str, float] = defaultdict(float)
    for s, e, n in clipped:
        kernel_s[n.split("(")[0]] += (e - s) / 1e9
    busy = _union([(s, e) for s, e, _ in clipped])
    busy_ns = sum(e - s for s, e in busy)
    # the idle gaps: between the window's edges and the busy intervals
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    # innermost host span holding each gap's midpoint, in one sweep over
    # the midpoints in order: the started spans in a heap by length, a
    # span that ended before a midpoint ended before every later one
    hs = sorted((s, e, n) for s, e, n in host_spans if e > s)
    idle: Dict[str, float] = defaultdict(float)
    active: list = []
    k = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while k < len(hs) and hs[k][0] <= mid:
            s, e, n = hs[k]
            heapq.heappush(active, (e - s, e, n))
            k += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        idle[active[0][2] if active else "(no host event)"] += (
            (g1 - g0) / 1e9)
    return Summary(busy_ns / 1e9, (w1 - w0) / 1e9, dict(kernel_s),
                   dict(idle))


def from_profiler(prof) -> Summary:
    """Summarize a finished torch.profiler.profile over the window, whose
    host range is the record_function WINDOW_RANGE.  The device's spans
    are its kernels, copies and sets."""
    from torch.autograd import DeviceType
    device, host = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            # a record_function range shows on the device's timeline too
            # (a user annotation), spanning work and gaps alike
            if not (e.is_user_annotation() or e.name().startswith("bench.")):
                device.append(span)
        elif e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW_RANGE:
                window = span[:2]
            else:
                host.append(span)
    if window is None:
        raise RuntimeError("the trace holds no %s range" % WINDOW_RANGE)
    return summarize(device, host, window)

"""Shared arithmetic of the per-layer metrics' readers.

A reader is ``read(ctx) -> float | None`` (ctx: run.Context); it returns
None where the run gave it nothing to read, and the harness then leaves
the metric out of the result line.
"""

from __future__ import annotations

from typing import Iterable, Optional


def idle_share(ctx) -> Optional[float]:
    """1 - busy / window of the traced window."""
    t = ctx.trace
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s


def ms_per(ctx, seconds: Optional[float], per: float) -> Optional[float]:
    """Milliseconds of ``seconds`` for each ``per`` units of the window's
    work."""
    if seconds is None or ctx.work <= 0:
        return None
    return 1e3 * seconds / (ctx.work / per)


def phases(ctx, names: Iterable[str]) -> Optional[float]:
    """The program's phase timers summed, or None if none of them ran."""
    got = [ctx.phases[n] for n in names if n in ctx.phases]
    return sum(got) if got else None

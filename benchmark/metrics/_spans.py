"""The program's own spans and counters (vsearch_tpu_torch/utils/
phasetimer): each span's self time, ``self_acc``, and the counters,
``tally``, of the traced window (run.py resets them before it).  A
program without them, or a window that did not reach a span or counter,
gives None, and the reader then reports nothing."""

from __future__ import annotations

from typing import Iterable, Optional

from vsearch_tpu_torch.utils import phasetimer


def self_time(names: Iterable[str]) -> Optional[float]:
    """The self time of the named spans summed, in seconds, or None if
    none of them ran."""
    own = getattr(phasetimer, "self_acc", None) or {}
    got = [own[n] for n in names if n in own]
    return sum(got) if got else None


def count(name: str) -> Optional[int]:
    """A counter of the window, or None if it counted nothing."""
    tally = getattr(phasetimer, "tally", None) or {}
    return tally.get(name) or None


def per(seconds: Optional[float], units: Optional[int],
        scale: float) -> Optional[float]:
    """``scale`` x seconds a unit."""
    if seconds is None or not units:
        return None
    return scale * seconds / units

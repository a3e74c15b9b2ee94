"""The card's peaks, the yardstick of every roofline share.

HBM: 3.35e12 bytes/s, NVIDIA's data sheet for the H100 SXM at 700 W.
Integer operations outside the tensor cores: an SM issues 128 lanes of
integer add and min/max a clock (measured on an H100 80GB HBM3 with
tools/int_rate.py: IADD3 and VIMNMX at 64 lanes a clock on each of two
pipes), so the rate is 128 x the SMs x the maximum SM clock, both read
from the card in the run; where every value of the function fits 16 bits,
a lane holds two (the 16x2 SIMD and DPX forms) and the rate doubles.
"""

from __future__ import annotations

import subprocess
from typing import Optional

HBM_BPS = 3.35e12
INT_LANES_PER_SM = 128


def max_sm_clock_hz() -> Optional[float]:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=30).stdout.split()
        return float(out[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def int_ops_per_s(sms: int, clock_hz: float, fits16: bool) -> float:
    return INT_LANES_PER_SM * sms * clock_hz * (2 if fits16 else 1)


def least_seconds(ops: float, nbytes: float, ops_rate: float) -> float:
    """The least time the card could take: the larger bound."""
    return max(ops / ops_rate, nbytes / HBM_BPS)

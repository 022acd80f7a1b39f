"""The arithmetic of the end-to-end metrics."""
from __future__ import annotations

from typing import Sequence


def rate(work: Sequence[float], window_s: float) -> float:
    """Work over the whole window: every step's work, over the wall time
    from the window's start to the end of its last step."""
    if window_s <= 0:
        raise ValueError("the window has no length")
    return float(sum(work)) / window_s


def percentile(xs: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every sample, interpolated linearly
    between order statistics (numpy's default)."""
    if not xs:
        raise ValueError("no samples")
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


"""Statistics over a whole window: percentiles over every sample, rates
over the window's time, and the union of intervals."""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


def percentile(samples: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` percentile of every sample (linear between order
    statistics, numpy's default); None without samples."""
    if len(samples) == 0:
        return None
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


def rate(work: float, seconds: float) -> Optional[float]:
    """Work over time; None over a window of no length."""
    return work / seconds if seconds > 0 else None


def clip(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of the intervals inside [lo, hi]."""
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Overlapping intervals merged, in order."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def covered(intervals: Iterable[Tuple[float, float]], lo: float,
            hi: float) -> float:
    """Length of [lo, hi] that at least one interval covers."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out

"""Device operations launched in a program span that lies inside another
(``model.mla`` inside ``engine.decode``, say), on the profiler's clock."""
from __future__ import annotations

from bisect import bisect_right


def _within(spans):
    """A test of whether a time lies in one of ``spans`` (sorted, not
    overlapping)."""
    starts = [a for a, _ in spans]

    def inside(t: float) -> bool:
        i = bisect_right(starts, t) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]
    return inside


def ops_launched_within(trace, inner: str, outer: str):
    """Device operations launched inside an ``inner`` range that starts
    inside an ``outer`` range."""
    in_outer = _within(sorted((a, b) for n, a, b in trace.ranges
                              if n == outer))
    in_inner = _within(sorted((a, b) for n, a, b in trace.ranges
                              if n == inner and in_outer(a)))
    return [op for op in trace.ops if op[3] is not None and in_inner(op[3])]


def window_prefills(run):
    """(start, end, prompt tokens) of each prefill that began in the
    measured window (the traced run's proxy times them)."""
    lo, hi = run.window
    return [p for p in getattr(run, "prefills", None) or []
            if lo <= p[0] <= hi]

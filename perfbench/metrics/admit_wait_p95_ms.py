"""admit_wait_p95_ms: the p95, over every ``engine.prefill`` span of the
traced window, of the time from the start of the ``engine.step`` span
that encloses it to its own start, in ms: how long a request waits in its
admitting step behind the prompts admitted before it. Program spans, on
the profiler's clock. Nothing is read where the trace has no such spans."""
from bisect import bisect_right

from perfbench import stats

STEP, PREFILL = "engine.step", "engine.prefill"


def read(run):
    trace = getattr(run, "trace", None)
    if trace is None:
        return None
    steps = sorted((a, b) for n, a, b in trace.ranges if n == STEP)
    starts = [a for a, _ in steps]
    lo, hi = trace.window
    waits = []
    for name, a, b in trace.ranges:
        if name != PREFILL or not lo <= a <= hi:
            continue
        i = bisect_right(starts, a) - 1
        if i >= 0 and b <= steps[i][1]:
            waits.append((a - steps[i][0]) / 1e3)
    return stats.percentile(waits, 95)

"""itl_p95_ms: 95th percentile of every gap between consecutive tokens of
every request, over the gaps that end in the window (two tokens that one
step() delivers are 0 apart). Host clock."""
from perfbench import stats


def read(run):
    if run.kind != "serve":
        return None
    t0, t1 = run.window
    gaps = [b - a for times in run.token_times
            for a, b in zip(times, times[1:]) if t0 < b <= t1]
    p = stats.percentile(gaps, 95)
    return None if p is None else p * 1e3

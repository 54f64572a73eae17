"""ttft_p95_ms: 95th percentile over every request sent in the window of
the time from its send to the return of the step() that delivered its
first token. A request with no first token is failed, not a sample.
Host clock."""
from perfbench import stats


def read(run):
    if run.kind != "serve":
        return None
    p = stats.percentile([r.times[0] - r.send for r in run.requests
                          if r.times], 95)
    return None if p is None else p * 1e3

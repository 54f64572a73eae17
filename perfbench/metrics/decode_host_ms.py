"""decode_host_ms: the mean host duration of the engine's ``engine.decode``
spans, in ms: what issuing one batched decode step costs the host, beside
``decode_ms``, its device time. Program spans, on the profiler's clock.
Nothing is read where the trace has no such span."""

SPAN = "engine.decode"


def read(run):
    trace = getattr(run, "trace", None)
    if trace is None:
        return None
    spans = [b - a for n, a, b in trace.ranges if n == SPAN]
    if not spans:
        return None
    return sum(spans) / len(spans) / 1e3

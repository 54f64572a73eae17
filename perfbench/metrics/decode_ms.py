"""decode_ms: device time of the operations launched inside the engine's
``engine.decode`` spans (the decode inputs and one batched decode step),
per span, in ms. Device trace, placed by launch. Nothing is read where the
trace has no such span or no device operation launched in one."""

SPAN = "engine.decode"


def read(run):
    trace = getattr(run, "trace", None)
    if trace is None:
        return None
    n = trace.range_count(SPAN)
    ops = trace.ops_launched_in(SPAN)
    if not n or not ops:
        return None
    return sum(b - a for _, a, b, _ in ops) / 1e3 / n

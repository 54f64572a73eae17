"""moe_decode_ms: device time of the operations launched inside the MoE
block's ``model.moe`` spans that lie inside the engine's ``engine.decode``
spans (router, dropless dispatch, expert products, combine, shared
experts), per ``engine.decode`` span, in ms. Device trace, placed by
launch. Nothing is read where the trace has no such span or no operation
launched in one."""
from perfbench.nested import ops_launched_within

SPAN, STEP = "model.moe", "engine.decode"


def read(run):
    trace = getattr(run, "trace", None)
    if trace is None:
        return None
    n = trace.range_count(STEP)
    ops = ops_launched_within(trace, SPAN, STEP)
    if not n or not ops:
        return None
    return sum(b - a for _, a, b, _ in ops) / 1e3 / n

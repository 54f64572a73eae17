"""moe_dispatch_ms: device time of the operations launched inside the MoE
layer's ``moe.route``, ``moe.dispatch`` and ``moe.combine`` spans (router
and aux loss; capacity one-hots, dispatch and the experts' inputs; the
weighted combine), in the forward pass and in block remat's recompute,
per ``train_step.forward`` span (one a train step), in ms. The expert
products (``moe.experts``) are left out. Device trace, placed by launch.
Nothing is read where the trace has no such spans."""

SPANS = ("moe.route", "moe.dispatch", "moe.combine")
STEP = "train_step.forward"


def read(run):
    trace = getattr(run, "trace", None)
    if trace is None:
        return None
    steps = trace.range_count(STEP)
    ops = [op for name in SPANS for op in trace.ops_launched_in(name)]
    if not steps or not ops:
        return None
    return sum(b - a for _, a, b, _ in ops) / 1e3 / steps

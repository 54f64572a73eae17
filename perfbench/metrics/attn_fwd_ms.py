"""attn_fwd_ms: device time of the operations launched inside the model's
``model.attn`` spans (the attention mixer of every layer, in the forward
pass and in block remat's recompute; not its gradient kernels), per
``train_step.forward`` span (one a train step), in ms. Device trace,
placed by launch. Nothing is read where the trace has no such spans."""

SPAN, STEP = "model.attn", "train_step.forward"


def read(run):
    trace = getattr(run, "trace", None)
    if trace is None:
        return None
    steps = trace.range_count(STEP)
    ops = trace.ops_launched_in(SPAN)
    if not steps or not ops:
        return None
    return sum(b - a for _, a, b, _ in ops) / 1e3 / steps

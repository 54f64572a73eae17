"""mla_prefill_ms_per_ktok: device time of the operations launched inside
the latent-attention mixer's ``model.mla`` spans that lie inside the
engine's ``engine.prefill`` spans (projections, latent norm, RoPE, cache
writes, the expansion and K1, output projection), over the prompt tokens
of the prefills begun in the window (the traced run's proxy counts them),
per thousand tokens, in ms. Device trace, placed by launch. Nothing is
read where the trace has no such span or the window no prefill."""
from perfbench.nested import ops_launched_within, window_prefills

SPAN, STEP = "model.mla", "engine.prefill"


def read(run):
    trace = getattr(run, "trace", None)
    prefills = window_prefills(run) if trace is not None else []
    if not prefills:
        return None
    ops = ops_launched_within(trace, SPAN, STEP)
    if not ops:
        return None
    tokens = sum(s for _, _, s in prefills)
    return sum(b - a for _, a, b, _ in ops) / 1e3 / tokens * 1e3

"""prefill_mfu: the window's prefills' useful model FLOPs (frozen count
from the prompt lengths and the configuration: weights, causal attention,
the head at the last position) over their time at the card's dense bf16
peak, in %. Host clock (prefill spans end in a synchronize)."""
from perfbench import flops, peaks


def read(run):
    spans = getattr(run, "prefills", None)
    if not spans:
        return None
    work = sum(flops.prefill_flops(run.cfg, s) for _, _, s in spans)
    seconds = sum(b - a for a, b, _ in spans)
    return 100.0 * work / (seconds * peaks.BF16_FLOPS)

"""k1_roofline: for every launch of kernel K1 (causal flash attention,
one a layer a prefill) the least time its shape allows, summed, over K1's
device time in the trace, in %. K1's kernel functions are the port's
``flash_fwd_wgmma``, ``flash_fwd_bf16`` and ``flash_fwd_f32``. Nothing
is read where the trace's K1 launches are not one a layer a prefill."""
from perfbench import flops

NAMES = ("flash_fwd_wgmma", "flash_fwd_bf16", "flash_fwd_f32")


def read(run):
    spans = getattr(run, "prefills", None)
    if run.trace is None or not spans:
        return None
    lo, hi = run.trace.window
    k1 = [o for o in run.trace.ops_named(*NAMES) if lo <= o[1] <= hi]
    cfg = run.cfg
    if not k1 or len(k1) != cfg["n_layers"] * len(spans):
        return None
    hd = flops.head_dim(cfg)
    bound = sum(cfg["n_layers"] * flops.k1_counts(
        s, s, cfg["n_heads"], cfg["n_kv_heads"], hd)["bound_s"]
        for _, _, s in spans)
    device = sum(b - a for _, a, b, _ in k1) / 1e6
    return 100.0 * bound / device

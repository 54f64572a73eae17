"""k1_mla_roofline: for every launch of kernel K1 in the engine's prefills
of a latent-attention model (one a layer a prefill, q·k over qk_nope +
qk_rope dims and v over v_head_dim, padded with zeros to K1's head dim)
the least time its useful work allows (``mla_flops.k1_mla_counts`` of the
unpadded shapes), summed, over K1's device time in the trace, in %. K1's
kernel functions are the port's ``flash_fwd_wgmma``, ``flash_fwd_bf16``
and ``flash_fwd_f32``. Nothing is read where the configuration has no
latent attention, or the K1 launches in ``engine.prefill`` are not one a
layer for each prefill begun in the window."""
from perfbench import mla_flops
from perfbench.nested import window_prefills

NAMES = ("flash_fwd_wgmma", "flash_fwd_bf16", "flash_fwd_f32")


def read(run):
    trace, cfg = getattr(run, "trace", None), run.cfg
    if trace is None or not (cfg.get("mla") or {}).get("kv_lora_rank"):
        return None
    prefills = window_prefills(run)
    k1 = [o for o in trace.ops_launched_in("engine.prefill")
          if any(n in o[0] for n in NAMES)]
    if not k1 or len(k1) != cfg["n_layers"] * len(prefills):
        return None
    H, qk, v = mla_flops.mla_sizes(cfg)
    bound = sum(cfg["n_layers"] * mla_flops.k1_mla_counts(s, H, qk, v)
                ["bound_s"] for _, _, s in prefills)
    device = sum(b - a for _, a, b, _ in k1) / 1e6
    return 100.0 * bound / device

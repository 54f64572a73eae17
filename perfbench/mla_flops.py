"""Frozen counts of the useful work of latent attention's prefill
attention, whatever computes it: for one layer and one prompt of S tokens
(causal, H heads, q·k over ``qk`` = qk_nope + qk_rope dims, v over ``v``
dims), the FLOPs of q·kᵀ and p·v over every causal pair, the bytes of the
unpadded q, k [S, H, qk] and v, o [S, H, v] read or written once, and the
least time the card allows. K1 pads q, k and v to its next head dim (256)
with zeros; that padding is not useful work and is not counted."""
from __future__ import annotations

from perfbench import flops, peaks


def mla_sizes(cfg: dict):
    """(heads, qk dims, v dims) of a configuration's ``model`` dict."""
    a = cfg["mla"]
    return (cfg["n_heads"], a["qk_nope_head_dim"] + a["qk_rope_head_dim"],
            a["v_head_dim"])


def k1_mla_counts(S: int, H: int, qk: int, v: int, elt: int = 2) -> dict:
    fl = 2 * flops.causal_pairs(S, S) * H * (qk + v)
    nbytes = elt * S * H * (2 * qk + 2 * v)
    bound = max(fl / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)
    return {"flops": fl, "bytes": nbytes, "bound_s": bound}

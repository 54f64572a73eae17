"""Mixture-of-Experts block: top-k router + capacity-based one-hot dispatch.

The reference's Switch/GShard-style dispatch, reproduced exactly: tokens
are processed in groups; each group builds a [G, E, C] dispatch tensor, so
which (token, k) slots are dropped, and the order in which tokens take the
capacity of an expert, are the reference's. Every expert computes its
whole capacity (the reference's einsum form), so an MoE layer reads all
experts' weights whatever the routing. An arctic-style parallel
dense-residual FFN is supported. With ``use_kernel`` the three expert
products go through ``kernels.ops.expert_gemm`` (the hand-written grouped
GEMM on CUDA tensors, its plain version on CPU tensors); the function is
the same. ``moe_apply`` runs in four spans (``obs.spans``): ``moe.route``,
``moe.dispatch``, ``moe.experts`` and ``moe.combine``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, split_evenly
from repro_torch.kernels import ops
from repro_torch.models.layers import _normal, ffn_apply, ffn_init
from repro_torch.obs.spans import span

# Tokens per dispatch group: bounds the [G, E, C] one-hot cost; the group
# size adapts to the expert width, as in the reference.
MAX_GROUP_SIZE = 2048


def group_size_for(cfg) -> int:
    return int(min(MAX_GROUP_SIZE, max(256, cfg.moe.d_expert)))


def moe_init(gen, cfg: ModelConfig, dtype, lead=()):
    """Router (float32 in any model dtype), experts, optional dense branch."""
    lead, m = tuple(lead), cfg.moe
    d, dff, E = cfg.d_model, m.d_expert, m.n_experts
    s_in, s_out = d ** -0.5, dff ** -0.5
    p = {
        "router": _normal(lead + (d, E), s_in, torch.float32, gen),
        "experts": {
            "w_up": _normal(lead + (E, d, dff), s_in, dtype, gen),
            "w_down": _normal(lead + (E, dff, d), s_out, dtype, gen),
        },
    }
    if cfg.act in ("swiglu", "geglu"):
        p["experts"]["w_gate"] = _normal(lead + (E, d, dff), s_in, dtype, gen)
    if m.dense_residual:
        p["dense"] = ffn_init(gen, d, m.d_dense_residual or cfg.d_ff, cfg.act,
                              dtype, lead)
    return p


def _activate(gate, up, act: str):
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    return F.gelu(up, approximate="tanh")


def top_k(x, k: int):
    """(values, indices) of the k largest along the last axis; on ties the
    lower index comes first, as ``jax.lax.top_k`` gives them."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router, xg, cfg: ModelConfig):
    """Routing of token groups xg [n, G, d].

    Returns (probs [n,G,E] float32, gate_vals [n,G,k] renormalised with the
    dropped slots zeroed, gate_idx [n,G,k], pos [n,G,k] (each slot's place
    in its expert), keep [n,G,k] (False: dropped for lack of capacity),
    capacity).
    """
    m = cfg.moe
    n, g_size, _ = xg.shape
    E, k = m.n_experts, m.top_k
    probs = torch.softmax(xg.float() @ router, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    # GShard-style minimum capacity: keeps tiny decode groups lossless
    capacity = int(max(4, k, round(g_size * k * m.capacity_factor / E)))
    capacity = min(capacity, g_size * k)
    # position of each (token, k) within its expert: a cumsum over the
    # k-major flattened one-hot choices, so earlier k-slots win
    oh = F.one_hot(gate_idx, E)                                  # [n,G,k,E]
    ohk = oh.transpose(1, 2).reshape(n, k * g_size, E)
    pos_k = torch.cumsum(ohk, dim=1) - ohk
    pos = pos_k.reshape(n, k, g_size, E).transpose(1, 2)
    pos = (pos * oh).sum(dim=-1)
    keep = pos < capacity
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return probs, gate_vals, gate_idx, pos, keep, capacity


def _expert_einsum(ex_in, w):
    """ex_in [n,E,C,d_in] @ w [E,d_in,d_out] per expert -> [n,E,C,d_out]:
    the reference's einsum."""
    return torch.einsum("necd,edf->necf", ex_in, w)


def _expert_gemm(ex_in, w):
    """The same product through ``ops.expert_gemm``, with ex_in laid out as
    [E, n·C, d_in] (a view for n = 1)."""
    n, E, C, _ = ex_in.shape
    y = ops.expert_gemm(ex_in.transpose(0, 1).reshape(E, n * C, -1), w)
    return y.reshape(E, n, C, -1).transpose(0, 1)


def moe_apply(params, x, cfg: ModelConfig,
              use_kernel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar float32).
    ``use_kernel`` sends the up, gate and down products through
    ``ops.expert_gemm``; otherwise they are the reference's einsums."""
    m = cfg.moe
    B, S, d = x.shape
    E = m.n_experts
    tokens = B * S
    g_size = min(group_size_for(cfg), tokens)
    if tokens % g_size:
        raise ValueError(f"{tokens} tokens do not split into MoE groups of "
                         f"{g_size}")
    xg = split_evenly(x, 0, tokens // g_size).reshape(
        tokens // g_size, g_size, d)
    with span("moe.route"):
        probs, gate_vals, gate_idx, pos, keep, capacity = route(
            params["router"], xg, cfg)
        # load-balancing aux loss (Switch eq. 4)
        me = probs.mean(dim=1)                                   # [n,E]
        ce = F.one_hot(gate_idx[..., 0], E).float().mean(dim=1)
        aux = (me * ce).sum(dim=-1).mean() * E * m.aux_loss_weight

    with span("moe.dispatch"):
        # combine[n,G,E,C]; a dropped slot's capacity one-hot is all zero.
        # The gates take x's dtype before the product, as in the reference.
        cap_oh = F.one_hot(torch.where(keep, pos, capacity),
                           capacity + 1)[..., :capacity].to(x.dtype)
        combine = torch.einsum("ngk,ngke,ngkc->ngec", gate_vals.to(x.dtype),
                               F.one_hot(gate_idx, E).to(x.dtype), cap_oh)
        dispatch = (combine > 0).to(x.dtype)
        combine = constrain(combine, "batch", None, "experts", None)
        dispatch = constrain(dispatch, "batch", None, "experts", None)
        ex_in = torch.einsum("ngd,ngec->necd", xg, dispatch)
        ex_in = constrain(ex_in, "batch", "experts", None, "embed")

    # expert computation: every expert over its whole capacity
    with span("moe.experts"):
        w = params["experts"]
        product = _expert_gemm if use_kernel else _expert_einsum
        up = product(ex_in, w["w_up"])
        gate = product(ex_in, w["w_gate"]) if "w_gate" in w else None
        h = constrain(_activate(gate, up, cfg.act),
                      "batch", "experts", None, "expert_ffn")
        ex_out = constrain(product(h, w["w_down"]),
                           "batch", "experts", None, "embed")
    with span("moe.combine"):
        out = torch.einsum("necd,ngec->ngd", ex_out, combine).reshape(B, S, d)
        out = constrain(out, "batch", "seq", "embed")
    if m.dense_residual:
        out = out + ffn_apply(params["dense"], x, cfg.act)
    return out, aux

"""Mixture-of-Experts block: top-k router + capacity-based one-hot dispatch,
or dropless dispatch by index.

The reference's Switch/GShard-style dispatch, reproduced exactly: tokens
are processed in groups; each group builds a [G, E, C] dispatch tensor, so
which (token, k) slots are dropped, and the order in which tokens take the
capacity of an expert, are the reference's. Every expert computes its
whole capacity (the reference's einsum form), so an MoE layer reads all
experts' weights whatever the routing. An arctic-style parallel
dense-residual FFN is supported; DeepSeek-V3's shared experts are that
branch. With ``use_kernel`` the three expert products go through
``kernels.ops.expert_gemm`` (the hand-written grouped GEMM on CUDA
tensors, its plain version on CPU tensors); the function is the same.
``moe_apply`` runs in four spans (``obs.spans``): ``moe.route``,
``moe.dispatch``, ``moe.experts`` and ``moe.combine``.

DeepSeek-V3 routing (``MoEConfig.scoring="sigmoid"``, ``selection_bias``,
``routed_scale``), for x the normed input of one token:

    s = sigmoid(x·W_r)                      float32 [E]
    chosen = top k of s + b                 ties to the lower index
    g = s[chosen] / Σ s[chosen] · scale     from the unbiased scores
    y = Σ_k g_k·Expert_k(x) + Shared(x)

``MoEConfig.dropless`` computes every (token, choice) pair: all tokens of
the call form one group, each pair's row is scattered by index into its
expert's slots ``[E, C, d]``, and each token's k outputs are gathered back
and summed in float32. C is the call's largest expert load (one read of
the loads from the device). A call of one position a row (a decode step)
reads nothing and scatters nothing: every expert takes every token in the
slot of the token's index, C being the call's token count, which bounds
every load (a token picks an expert at most once). No aux loss is computed
on that path (DeepSeek-V3 balances through the selection bias, outside
the gradient).
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
# the selection bias's init scale (DeepSeek-V3 learns it from zero; a
# non-zero draw makes biased and unbiased selection differ)
BIAS_SCALE = 0.1


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
    if m.selection_bias:
        p["router_bias"] = _normal(lead + (E,), BIAS_SCALE, torch.float32, gen)
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


def choose(router, x, cfg: ModelConfig, bias=None):
    """The router's choice for tokens x [..., d]: (scores [..., E] float32,
    gates [..., k] float32, experts [..., k]). Softmax or sigmoid scores;
    the top k of the scores, or of scores + ``bias`` where given (the
    gates still the unbiased scores); renormalised, then scaled by
    ``routed_scale``."""
    m = cfg.moe
    logits = x.float() @ router
    scores = (torch.sigmoid(logits) if m.scoring == "sigmoid"
              else torch.softmax(logits, dim=-1))
    if bias is None:
        gates, idx = top_k(scores, m.top_k)
    else:
        _, idx = top_k(scores + bias, m.top_k)
        gates = scores.gather(-1, idx)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    if m.routed_scale != 1.0:
        gates = gates * m.routed_scale
    return scores, gates, idx


def route(router, xg, cfg: ModelConfig, bias=None):
    """Routing of token groups xg [n, G, d].

    Returns (probs [n,G,E] float32, gate_vals [n,G,k] renormalised with the
    dropped slots zeroed, gate_idx [n,G,k], pos [n,G,k] (each slot's place
    in its expert), keep [n,G,k] (False: dropped for lack of capacity),
    capacity).
    """
    m = cfg.moe
    n, g_size, _ = xg.shape
    E, k = m.n_experts, m.top_k
    probs, gate_vals, gate_idx = choose(router, xg, cfg, bias)
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
    if m.dropless:
        return _dropless_apply(params, x, cfg, use_kernel), 0.0
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
            params["router"], xg, cfg, params.get("router_bias"))
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


def _dropless_apply(params, x, cfg: ModelConfig, use_kernel: bool):
    """x [B, S, d] -> out [B, S, d] with every (token, choice) pair
    computed (the module docstring's dropless dispatch)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    xt = x.reshape(B * S, d)
    with span("moe.route"):
        _, gates, idx = choose(params["router"], xt, cfg,
                               params.get("router_bias"))
    with span("moe.dispatch"):
        e = idx.reshape(-1)
        if S == 1:
            # a decode step: every expert takes every token, each in the
            # slot of its own index (capacity = the call's tokens)
            slot = torch.arange(B, device=x.device).repeat_interleave(k)
            ex_in = xt.expand(E, B, d)[None]
        else:
            # each pair's slot in its expert: its rank among the expert's
            # pairs in (token, choice) order
            order = torch.argsort(e, stable=True)
            load = torch.bincount(e, minlength=E)
            start = torch.cumsum(load, 0) - load
            slot = torch.empty_like(e)
            slot[order] = (torch.arange(e.numel(), device=e.device)
                           - start[e[order]])
            ex_in = x.new_zeros((1, E, int(load.max()), d))
            ex_in[0, e, slot] = xt.repeat_interleave(k, dim=0)
    with span("moe.experts"):
        w = params["experts"]
        product = _expert_gemm if use_kernel else _expert_einsum
        h = _activate(product(ex_in, w["w_gate"]) if "w_gate" in w else None,
                      product(ex_in, w["w_up"]), cfg.act)
        ex_out = product(h, w["w_down"])
    with span("moe.combine"):
        y = ex_out[0, e, slot].reshape(B * S, k, d)
        out = (y.float() * gates[..., None]).sum(dim=1).to(x.dtype)
        out = out.reshape(B, S, d)
    if m.dense_residual:
        out = out + ffn_apply(params["dense"], x, cfg.act)
    return out

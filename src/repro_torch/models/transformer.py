"""Block stack: layers grouped by position within a repeating period.

The parameter and cache layout is the reference's: ``{posNN: tree}`` with a
leading ``n_groups`` axis on every leaf, so converted weights and caches
compare one for one. Where the reference scans over groups, the port loops
in Python. Every mixer kind is ported: attention, Mamba (``ssm``), mLSTM
and sLSTM; the port adds latent attention (``mla``, which the reference
lacks). Attention and Mamba layers take an MoE block or a dense FFN.
The MoE aux loss is summed over the layers of a group, then over groups,
as the reference sums it.

On the training path (``training=True``, no caches) each group is
recomputed in the backward pass as ``cfg.remat`` asks: ``"block"`` keeps
the outputs of the weight matmuls (``aten.mm``/``addmm``, the counterpart
of the reference's ``dots_with_no_batch_dims_saveable``) and recomputes
the rest, ``"full"`` keeps only the group's input, ``"none"`` keeps
everything. Serving ignores ``remat``.

Caches are written in place: attention writes its new keys and values into
the k/v tensors it is given (latent attention its latent and RoPE key into
``ckv``/``kpe``), and the recurrent layers copy their new state
into the state tensors of the cache (``{posNN: {conv, h}}`` for Mamba,
``{posNN: {C, n, m, conv}}`` for mLSTM, ``{posNN: {c, n, m, h}}`` for
sLSTM, each with the leading ``n_groups`` axis).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import loops
from repro_torch.models import mla
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm
from repro_torch.models.layers import ffn_apply, ffn_init, rmsnorm, rmsnorm_init
from repro_torch.obs.spans import span

_MIXER_INIT = {"attn": attn.attn_init, "mla": mla.mla_init,
               "ssm": ssm_lib.ssm_init, "mlstm": xlstm.mlstm_init,
               "slstm": xlstm.slstm_init}
_ATTENTION = {"attn": attn.attn_apply, "mla": mla.mla_apply}
_MIXER_SPAN = {kind: f"model.{kind}" for kind in _MIXER_INIT}


def _pos_name(p: int) -> str:
    return f"pos{p:02d}"


def _index(tree, g: int):
    """Group g of a stacked tree (views, so writes reach the stack)."""
    return {k: _index(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def _groups(tree, n: int) -> List[Dict[str, Any]]:
    """The n groups of a stacked tree, as views. One ``unbind`` a leaf, so
    the backward pass stacks a leaf's n gradients once (indexing each group
    on its own would make n full-size gradients of every leaf)."""
    out = [dict() for _ in range(n)]
    for k, v in tree.items():
        parts = _groups(v, n) if isinstance(v, dict) else torch.unbind(v)
        for g in range(n):
            out[g][k] = parts[g]
    return out


_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def stack_init(gen, cfg: ModelConfig, dtype) -> Dict[str, Any]:
    """Stacked params: {posNN: block params with leading n_groups dim}."""
    G, dev = cfg.n_groups, gen.device
    out = {}
    for p in range(cfg.resolved_scan_period):
        kind = cfg.layer_kind(p)
        block = {"mixer_norm": rmsnorm_init(cfg.d_model, (G,), dev),
                 "mixer": _MIXER_INIT[kind](gen, cfg, dtype, (G,))}
        if kind in ("attn", "mla", "ssm"):
            if cfg.layer_is_moe(p):
                block["ffn_norm"] = rmsnorm_init(cfg.d_model, (G,), dev)
                block["moe"] = moe_lib.moe_init(gen, cfg, dtype, (G,))
            elif cfg.d_ff > 0:
                block["ffn_norm"] = rmsnorm_init(cfg.d_model, (G,), dev)
                block["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                        dtype, (G,))
        out[_pos_name(p)] = block
    out["final_norm"] = rmsnorm_init(cfg.d_model, (), dev)
    return out


def block_apply(params, x, positions, cfg: ModelConfig, layer_pos: int,
                cache: Optional[Dict] = None, cache_index=None,
                use_kernel: bool = False):
    """Apply one block (its cache, if any, is written in place). Returns
    (x, aux): aux is the MoE load-balancing loss, a float32 scalar tensor,
    or the number 0.0 without MoE (no kernel on the serving paths). The
    mixer runs in the span ``model.<kind>`` (with a recurrent layer's
    state copy), the FFN in ``model.ffn``, the MoE block in ``model.moe``;
    the norms and residual adds in none."""
    kind = cfg.layer_kind(layer_pos)
    aux = 0.0
    h = rmsnorm(params["mixer_norm"], x, cfg.norm_eps)
    with span(_MIXER_SPAN[kind]):
        if kind in _ATTENTION:
            out = _ATTENTION[kind](params["mixer"], h, positions, cfg,
                                   cache=cache, cache_index=cache_index,
                                   use_kernel=use_kernel)
        else:
            if kind == "ssm":
                out, state = ssm_lib.ssm_apply(params["mixer"], h, cfg,
                                               state=cache,
                                               use_kernel=use_kernel)
            elif kind == "mlstm":
                out, state = xlstm.mlstm_apply(params["mixer"], h, cfg,
                                               state=cache)
            else:
                out, state = xlstm.slstm_apply(params["mixer"], h, cfg,
                                               state=cache,
                                               use_kernel=use_kernel)
            if cache is not None:
                for key, value in state.items():
                    cache[key].copy_(value)
    x = x + out
    if "moe" in params:
        h = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
        # K2 takes prefill's expert products; a decode step's (one token a
        # lane, with a cache) stay einsums
        decode = cache is not None and x.shape[1] == 1
        with span("model.moe"):
            out, aux = moe_lib.moe_apply(params["moe"], h, cfg,
                                         use_kernel=use_kernel and not decode)
        x = x + out
    elif "ffn" in params:
        h = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
        with span("model.ffn"):
            out = ffn_apply(params["ffn"], h, cfg.act)
        x = x + out
    return x, aux


def _group_apply(group_params, x, positions, cfg: ModelConfig,
                 group_caches: Optional[Dict], cache_index, use_kernel: bool,
                 training: bool):
    """One group: ``period`` consecutive blocks. Returns (x, aux summed
    over the group's blocks); aux is summed only when ``training``, so
    serving launches nothing for it."""
    aux = 0.0
    for p in range(cfg.resolved_scan_period):
        name = _pos_name(p)
        cache = group_caches[name] if group_caches is not None else None
        x, a = block_apply(group_params[name], x, positions, cfg, p,
                           cache=cache, cache_index=cache_index,
                           use_kernel=use_kernel)
        if training:
            aux = aux + a
    return x, aux


def stack_apply(params, x, positions, cfg: ModelConfig,
                caches: Optional[Dict] = None, cache_index=None,
                use_kernel: bool = False, training: bool = False):
    """Run all groups in order. caches: {posNN: stacked cache}, written in
    place. ``training`` (no caches) recomputes each group in the backward
    pass as ``cfg.remat`` asks. Returns (x, caches, aux), aux summed over
    the groups when ``training`` (else, and without MoE, 0.0)."""
    G = cfg.n_groups
    names = [_pos_name(p) for p in range(cfg.resolved_scan_period)]
    blocks = _groups({n: params[n] for n in names}, G)
    apply = _group_apply
    if training and caches is None and cfg.remat != "none":
        if cfg.remat not in ("block", "full"):
            raise ValueError(f"remat={cfg.remat!r}")
        context = (functools.partial(create_selective_checkpoint_contexts,
                                     _save_weight_matmuls)
                   if cfg.remat == "block" else None)

        def apply(*args):
            kw = {"context_fn": context} if context is not None else {}
            return checkpoint(_group_apply, *args, use_reentrant=False, **kw)
    aux = 0.0
    for g in loops.steps(G, x):
        group_caches = ({n: _index(caches[n], g) for n in names}
                        if caches is not None else None)
        x, a = apply(blocks[g], x, positions, cfg, group_caches, cache_index,
                     use_kernel, training)
        if training:
            aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, caches, aux


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device="cpu") -> Dict[str, Any]:
    """Stacked caches {posNN: tree with a leading n_groups axis}: attention
    {k, v: [n_groups, B, L, Hkv, hd]}, latent attention {ckv: [n_groups,
    B, L, kv_lora_rank], kpe: [n_groups, B, L, qk_rope_head_dim]}, or a Mamba or xLSTM layer's
    recurrent state (which does not grow with ``max_len``)."""
    out = {}
    lead = (cfg.n_groups,)
    for p in range(cfg.resolved_scan_period):
        kind = cfg.layer_kind(p)
        if kind in ("attn", "mla"):
            init = attn.init_cache if kind == "attn" else mla.init_cache
            cache = init(cfg, batch, max_len, dtype, device, lead=lead)
        elif kind == "ssm":
            cache = ssm_lib.init_ssm_state(cfg, batch, dtype, device,
                                           lead=lead)
        else:
            cache = xlstm.init_xlstm_state(cfg, batch, kind, dtype, device,
                                           lead=lead)
        out[_pos_name(p)] = cache
    return out

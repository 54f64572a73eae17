"""Multi-head latent attention (MLA, DeepSeek-V2/V3) without a query LoRA.

For x the normed input [B, S, d] at positions ``pos``, H heads, sizes from
``cfg.mla`` (nope, rope, v and the latent r):

    q = x·W_q -> [H, nope + rope];  q_pe = RoPE(q[..., nope:])
    [c, k_pe] = x·W_kva             c [r]; k_pe [rope], one head for all H
    c = RMSNorm_kv(c);  k_pe = RoPE(k_pe)
    the cache holds c and k_pe: {ckv: [G, B, L, r], kpe: [G, B, L, rope]}

Expanded form (prefill, S > 1):

    [k_nope, v] = c·W_kvb -> [H, nope], [H, v];  k = [k_nope, k_pe]
    o = softmax(q·kᵀ · (nope + rope)^-0.5, causal)·v;  out = o·W_o

Absorbed form (decode, S = 1), over the latent cache as laid out, with no
copy or expansion of it (W_uk, W_uv: the two halves of W_kvb):

    q_lat[h] = q_nope[h]·W_uk[h]ᵀ                      [r]
    s[h,t] = (q_lat[h]·c[t] + q_pe[h]·k_pe[t]) · (nope + rope)^-0.5
    o[h] = (Σ_t softmax(s)[h,t]·c[t])·W_uv[h];  out = o·W_o

RoPE rotates interleaved pairs, as ``layers.apply_rope``. With
``use_kernel`` the expanded attention goes through
``kernels.ops.flash_attention`` (K1 on CUDA tensors) with q, k and v
zero-padded to the kernel's next head dim and the scale passed; zero
columns add nothing to q·k or to the output, so the result is exact.
Without it, the plain ``flash_attention_ref``, which takes any S. The
absorbed decode is plain PyTorch: its scores come from bf16 products of a
bf16 model (summed in float32), the softmax in float32.

``mla_apply`` runs in two spans (``obs.spans``): ``mla.latent`` (the
projections of q and the latent, the latent's norm, RoPE and the cache
write) and ``mla.attend`` (the expansion and the attention, or the
absorption products and the attention over the latent); the output
projection is in neither.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_ref
from repro_torch.models.attention import _out_proj, _proj
from repro_torch.models.layers import _normal, apply_rope, rmsnorm, rmsnorm_init
from repro_torch.obs.spans import span


def mla_init(gen, cfg: ModelConfig, dtype, lead=()):
    lead, a = tuple(lead), cfg.mla
    d, H, r = cfg.d_model, cfg.n_heads, a.kv_lora_rank
    return {
        "wq": _normal(lead + (d, H, a.qk_head_dim), d ** -0.5, dtype, gen),
        "wkv_a": _normal(lead + (d, r + a.qk_rope_head_dim), d ** -0.5,
                         dtype, gen),
        "kv_norm": rmsnorm_init(r, lead, gen.device),
        "wkv_b": _normal(lead + (r, H, a.qk_nope_head_dim + a.v_head_dim),
                         r ** -0.5, dtype, gen),
        "wo": _normal(lead + (H, a.v_head_dim, d), (H * a.v_head_dim) ** -0.5,
                      dtype, gen),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device="cpu", lead=()):
    a, shape = cfg.mla, tuple(lead) + (batch, max_len)
    return {"ckv": torch.zeros(shape + (a.kv_lora_rank,), dtype=dtype,
                               device=device),
            "kpe": torch.zeros(shape + (a.qk_rope_head_dim,), dtype=dtype,
                               device=device)}


def mla_apply(params, x, positions, cfg: ModelConfig,
              cache: Optional[Dict] = None, cache_index=None,
              use_kernel: bool = False):
    """The layer's output [B, S, d]. cache=None: attention over x alone.
    With a cache, S == 1 is a decode step writing at ``cache_index`` (an
    int or a [B] tensor of per-lane positions); otherwise prefill writes
    [0, S) and attends over what it wrote."""
    a = cfg.mla
    B, S, _ = x.shape
    nope, r = a.qk_nope_head_dim, a.kv_lora_rank
    scale = a.qk_head_dim ** -0.5
    with span("mla.latent"):
        q = _proj(x, params["wq"])
        q_nope = q[..., :nope]
        kva = x @ params["wkv_a"]
        c = rmsnorm(params["kv_norm"], kva[..., :r], cfg.norm_eps)
        # q_pe's H heads and k_pe's one rotated in one call
        pe = apply_rope(torch.cat([q[..., nope:], kva[..., None, r:]], dim=-2),
                        positions, cfg)
        q_pe, k_pe = pe[..., :-1, :], pe[..., -1, :]
        if cache is not None:
            ckv, kpe = cache["ckv"], cache["kpe"]
            if torch.is_tensor(cache_index) and cache_index.dim() == 1:
                lanes = torch.arange(B, device=ckv.device)
                ckv[lanes, cache_index] = c[:, 0].to(ckv.dtype)
                kpe[lanes, cache_index] = k_pe[:, 0].to(kpe.dtype)
            else:
                i = int(cache_index)
                ckv[:, i:i + S] = c.to(ckv.dtype)
                kpe[:, i:i + S] = k_pe.to(kpe.dtype)
            if S > 1:   # prefill attends over the cache, in its dtype
                c, k_pe = ckv[:, :S], kpe[:, :S]
    with span("mla.attend"):
        if cache is not None and S == 1:
            o = _absorbed(params["wkv_b"], q_nope, q_pe, ckv, kpe,
                          cache_index, nope, scale)
        else:
            o = _expanded(params["wkv_b"], q_nope, q_pe, c, k_pe, nope,
                          scale, use_kernel)
    return _out_proj(o, params["wo"])


def _expanded(wkv_b, q_nope, q_pe, c, k_pe, nope: int, scale: float,
              use_kernel: bool):
    """Causal attention of the expanded form -> o [B, S, H, v]."""
    kv = _proj(c, wkv_b)                                   # [B,S,H,nope+v]
    H = kv.shape[2]
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(-1, -1, H, -1)],
                  dim=-1)
    v = kv[..., nope:]
    q = torch.cat([q_nope, q_pe], dim=-1)
    if not use_kernel:
        return flash_attention_ref(q, k, v, causal=True, scale=scale)
    return padded_flash_attention(q, k, v, scale)


def padded_flash_attention(q, k, v, scale: float):
    """Causal ``ops.flash_attention`` of q, k [B,S,H,qk] and v [B,S,H,hv]
    zero-padded to the kernel's next head dim, scores scaled by ``scale``
    -> [B,S,H,hv]: exact, since zero columns add nothing."""
    hd_v = v.shape[-1]
    hd = next(h for h in HEAD_DIMS if h >= max(q.shape[-1], hd_v))
    q, k, v = (F.pad(t, (0, hd - t.shape[-1])) for t in (q, k, v))
    return ops.flash_attention(q, k, v, causal=True, scale=scale)[..., :hd_v]


def _absorbed(wkv_b, q_nope, q_pe, ckv, kpe, cache_index, nope: int,
              scale: float):
    """One query a lane against its latent cache up to ``cache_index``
    (an int or a [B] tensor) -> o [B, 1, H, v]."""
    B, L = ckv.shape[0], ckv.shape[1]
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], wkv_b[..., :nope])
    s = (torch.bmm(q_lat, ckv.transpose(1, 2))
         + torch.bmm(q_pe[:, 0], kpe.transpose(1, 2))).float() * scale
    last = (cache_index if torch.is_tensor(cache_index)
            else torch.full((B,), int(cache_index), device=ckv.device))
    seen = torch.arange(L, device=ckv.device)[None, :] <= last[:, None]
    p = torch.softmax(s.masked_fill(~seen[:, None, :], float("-inf")),
                      dim=-1).to(ckv.dtype)
    o_lat = torch.bmm(p, ckv)                               # [B,H,r]
    return torch.einsum("bhr,rhv->bhv", o_lat, wkv_b[..., nope:])[:, None]

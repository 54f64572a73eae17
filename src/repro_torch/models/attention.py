"""GQA/MQA/MHA attention with KV cache, causal/sliding-window masking.

Prefill uses plain PyTorch attention (``full_attention``, or
``chunked_attention`` above ``FULL_ATTN_MAX``) or, with ``use_kernel``, the
flash-attention kernel through ``kernels.ops`` (on CUDA tensors the
hand-written kernel, on CPU tensors its plain version). Decode attends one
query per lane against the whole cache in plain PyTorch, as the reference,
or, with ``use_kernel``, through ``kernels.ops.decode_attention``: on CUDA
tensors the decode kernel, which reads each lane's cache in place up to its
position; on CPU tensors the same plain version.

Unlike the reference, cache writes are in place: ``attn_apply`` writes the
new keys and values into the cache tensors it is given.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.models import loops
from repro_torch.models.layers import NEG_INF, _normal, apply_rope

CHUNK_Q = 1024
CHUNK_K = 1024
FULL_ATTN_MAX = 1024  # above this, use the chunked (flash-style) path


def attn_init(gen, cfg: ModelConfig, dtype, lead=()):
    lead = tuple(lead)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    s = d ** -0.5
    return {
        "wq": _normal(lead + (d, cfg.n_heads, hd), s, dtype, gen),
        "wk": _normal(lead + (d, cfg.n_kv_heads, hd), s, dtype, gen),
        "wv": _normal(lead + (d, cfg.n_kv_heads, hd), s, dtype, gen),
        "wo": _normal(lead + (cfg.n_heads, hd, d),
                      (cfg.n_heads * hd) ** -0.5, dtype, gen),
    }


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out_proj(o, wo):
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return o.reshape(*o.shape[:-2], h * k) @ wo.reshape(h * k, d)


def _qkv(params, x, positions, cfg: ModelConfig):
    q = apply_rope(_proj(x, params["wq"]), positions, cfg)
    k = apply_rope(_proj(x, params["wk"]), positions, cfg)
    v = _proj(x, params["wv"])
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    # K/V use "kv_seq" (default: replicated over seq)
    k = constrain(k, "batch", "kv_seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "kv_seq", "kv_heads", "head_dim")
    return q, k, v


def _kv_for(q, k, v):
    """k and v as the attention of ``q`` takes them. On a mesh where the
    query heads are split over more devices than divide the kv heads
    (phi4's 32 padded heads over 16, 8 kv heads), a head group cannot be
    a DTensor dimension (XLA tiles the group dims; DTensor cannot), so the
    kv heads are repeated to one per query head: the same products, the
    kv bytes G times. Otherwise (and for plain tensors) k and v."""
    if not hasattr(q, "placements"):
        return k, v
    mesh, Hq, Hkv = q.device_mesh, q.shape[2], k.shape[2]
    ways = 1
    for i, p in enumerate(q.placements):
        if p.is_shard(q.dim() - 2):
            ways *= mesh.size(i)
    if ways == 1 or Hkv % ways == 0:
        return k, v
    return _RepeatKV.apply(k, Hq // Hkv), _RepeatKV.apply(v, Hq // Hkv)


class _RepeatKV(torch.autograd.Function):
    """kv heads repeated G times on dim 2. The gradient sums each group
    back; a gradient split over the repeated heads is gathered first (the
    group view of a split head dim is what DTensor cannot take)."""

    @staticmethod
    def forward(ctx, t, G):
        ctx.G = G
        return t.repeat_interleave(G, dim=2)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        if any(p.is_shard(2) for p in g.placements):
            g = g.redistribute(g.device_mesh, [
                Replicate() if p.is_shard(2) else p for p in g.placements])
        B, T, H, hd = g.shape
        return g.reshape(B, T, H // ctx.G, ctx.G, hd).sum(dim=3), None


def _softcap(logits, cap: float):
    if cap > 0.0:
        logits = torch.tanh(logits / cap) * cap
    return logits


def full_attention(q, k, v, cfg: ModelConfig):
    """Causal (optionally sliding-window) attention, grouped for GQA.

    q: [B,S,Hq,hd], k/v: [B,T,Hkv,hd]; returns [B,S,Hq,hd]. fp32 softmax.
    """
    k, v = _kv_for(q, k, v)
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    logits = _softcap(logits * hd ** -0.5, cfg.attn_logit_softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = kpos <= qpos
    if cfg.sliding_window > 0:
        mask &= kpos > qpos - cfg.sliding_window
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, Hq, hd)


def chunked_attention(q, k, v, cfg: ModelConfig, chunk_q: int = CHUNK_Q,
                      chunk_k: int = CHUNK_K):
    """Flash-style causal attention over (q, k) chunks with a running max;
    never materialises an [S, T] matrix. Computes every block pair and
    masks, as the reference's scan does.
    """
    k, v = _kv_for(q, k, v)
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    chunk_q, chunk_k = min(chunk_q, S), min(chunk_k, T)
    if S % chunk_q or T % chunk_k:
        raise ValueError(f"S={S}, T={T} not multiples of chunks "
                         f"{chunk_q}, {chunk_k}")
    scale = hd ** -0.5
    outs = []
    n_q = S // chunk_q
    for q0 in (i * chunk_q for i in loops.steps(n_q, q)):
        qb = q[:, q0:q0 + chunk_q].reshape(B, chunk_q, Hkv, G, hd)
        qpos = torch.arange(q0, q0 + chunk_q, device=q.device)
        m = torch.full((B, Hkv, G, chunk_q), float("-inf"), device=q.device)
        num = torch.zeros((B, Hkv, G, chunk_q, hd), device=q.device)
        den = torch.zeros((B, Hkv, G, chunk_q), device=q.device)
        for k0 in (i * chunk_k for i in loops.steps(T // chunk_k, k)):
            kb, vb = k[:, k0:k0 + chunk_k], v[:, k0:k0 + chunk_k]
            kpos = torch.arange(k0, k0 + chunk_k, device=q.device)
            logits = torch.einsum("bqkgh,bskh->bkgqs", qb, kb).float()
            logits = _softcap(logits * scale, cfg.attn_logit_softcap)
            mask = kpos[None, :] <= qpos[:, None]
            if cfg.sliding_window > 0:
                mask &= kpos[None, :] > qpos[:, None] - cfg.sliding_window
            logits = logits.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            num = num * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vb.float())
            den = den * alpha + p.sum(dim=-1)
            m = m_new
        out = num / den.clamp_min(1e-30)[..., None]
        # [B,Hkv,G,chunk_q,hd] -> [B,chunk_q,Hq,hd]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, chunk_q, Hq, hd)
                    .to(q.dtype))
    return torch.cat(loops.fill(outs, n_q), dim=1)


def attn_apply(params, x, positions, cfg: ModelConfig,
               cache: Optional[Dict] = None, cache_index=None,
               use_kernel: bool = False):
    """Returns the attention output. cache=None -> prefill without a cache.

    With a cache: S == 1 is a decode step writing at ``cache_index`` (an int
    or a [B] tensor of per-lane positions); otherwise prefill writes [0, S).
    The write goes into ``cache`` in place. ``use_kernel`` sends prefill
    attention (S > 1) through ``ops.flash_attention`` and a decode step's
    through ``ops.decode_attention``.
    """
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, positions, cfg)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        if torch.is_tensor(cache_index) and cache_index.dim() == 1:
            # per-lane write positions (continuous batching)
            lanes = torch.arange(B, device=ck.device)
            ck[lanes, cache_index] = k[:, 0].to(ck.dtype)
            cv[lanes, cache_index] = v[:, 0].to(cv.dtype)
        else:
            i = int(cache_index)
            ck[:, i:i + S] = k.to(ck.dtype)
            cv[:, i:i + S] = v.to(cv.dtype)
        if S == 1:
            if use_kernel:
                from repro_torch.kernels import ops

                out = ops.decode_attention(
                    q, ck, cv, cache_index, window=cfg.sliding_window,
                    softcap=cfg.attn_logit_softcap)
            else:
                out = decode_attention(q, ck, cv, cache_index, cfg)
            return constrain(_out_proj(out, params["wo"]),
                             "batch", "seq", "embed")
        # prefill attends over the cache, so K and V pass the cache dtype
        k, v = ck[:, :S], cv[:, :S]
    if use_kernel and S > 1:
        from repro_torch.kernels.ops import flash_attention

        out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                              softcap=cfg.attn_logit_softcap)
    elif S > FULL_ATTN_MAX:
        out = chunked_attention(q, k, v, cfg)
    else:
        out = full_attention(q, k, v, cfg)
    return constrain(_out_proj(out, params["wo"]), "batch", "seq", "embed")


def decode_attention(q, ck, cv, cache_index, cfg: ModelConfig):
    """Single-token attention vs. the full cache.

    q: [B,1,Hq,hd], ck/cv: [B,L,Hkv,hd]; positions after ``cache_index``
    (an int or a [B] tensor) are masked. The decode kernel's plain version
    (``kernels/decode_attention.py::decode_attention_ref``), on k and v as
    ``_kv_for`` gives them.
    """
    ck, cv = _kv_for(q, ck, cv)
    return decode_attention_ref(q, ck, cv, cache_index,
                                window=cfg.sliding_window,
                                softcap=cfg.attn_logit_softcap)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device="cpu", lead=()):
    shape = tuple(lead) + (batch, max_len, cfg.n_kv_heads,
                           cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}

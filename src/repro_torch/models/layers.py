"""Shared primitive layers: norms, RoPE, FFN, embeddings.

Functions take the parameter dict of their layer (the reference's key
layout) and tensors in the reference's layouts. ``constrain`` marks the
reference's sharding points: a no-op outside a mesh step's rules
(``distributed/sharding.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain

NEG_INF = -2.3819763e38  # large negative, safe in bfloat16


def _normal(shape, scale, dtype, gen):
    # scaled in place: one float32 temporary per leaf (7.5 GB for a
    # full-width Jamba expert stack), not two
    t = torch.randn(shape, generator=gen, device=gen.device)
    return t.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, lead=(), device="cpu"):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32,
                                device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    """RMS norm computed in float32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (interleaved pairs, optional partial fraction)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, fraction: float, theta: float, device="cpu"):
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x, positions, cfg: ModelConfig):
    """x: [..., seq, heads, head_dim]; positions broadcastable to [..., seq].

    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2]) of the leading
    ``rope_fraction`` of head_dim (x's last axis), as the reference does
    (not rotate-half).
    """
    inv, rot = rope_freqs(x.shape[-1], cfg.rope_fraction, cfg.rope_theta,
                          x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv        # [..., seq, rot/2]
    cos = torch.cos(ang)[..., None, :]                  # [..., seq, 1, rot/2]
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    if rot < x.shape[-1]:
        out = torch.cat([out.to(x.dtype), xp], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN: swiglu / geglu / gelu (both GELUs use the tanh approximation)
# ---------------------------------------------------------------------------

def ffn_init(gen, d_model: int, d_ff: int, act: str, dtype, lead=()):
    lead = tuple(lead)
    p = {
        "w_up": _normal(lead + (d_model, d_ff), d_model ** -0.5, dtype, gen),
        "w_down": _normal(lead + (d_ff, d_model), d_ff ** -0.5, dtype, gen),
    }
    if act in ("swiglu", "geglu"):
        p["w_gate"] = _normal(lead + (d_model, d_ff), d_model ** -0.5, dtype, gen)
    return p


def ffn_apply(params, x, act: str):
    up = constrain(x @ params["w_up"], "batch", "seq", "ffn")
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    elif act == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    return constrain(h @ params["w_down"], "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------

def embed_init(gen, cfg: ModelConfig, dtype):
    V, d = cfg.padded_vocab, cfg.d_model
    p = {"tok_embed": _normal((V, d), 0.02, dtype, gen)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((d, V), d ** -0.5, dtype, gen)
    if cfg.frontend != "none":
        p["frontend_proj"] = _normal((cfg.frontend_dim, d),
                                     cfg.frontend_dim ** -0.5, dtype, gen)
    return p


def embed_tokens(params, tokens, cfg: ModelConfig,
                 frontend_embeds: Optional[torch.Tensor] = None):
    """tokens: [B, S] int. frontend_embeds: [B, F, frontend_dim] or None.

    Modality stub: the first F positions are replaced by projected
    frontend embeddings.
    """
    if hasattr(tokens, "placements") and tokens.device_mesh.size() > 1:
        # the same rows, from the table gathered whole: DTensor's index_put
        # (indexing's backward) mislays a split index in some versions,
        # and a vocab-split lookup's masked partial sums cannot take every
        # gradient layout that meets them (a tied head's, a 3-D mesh's)
        from torch.distributed.tensor import Replicate

        w = params["tok_embed"]
        x = F.embedding(tokens, w.redistribute(
            w.device_mesh, [Replicate()] * w.device_mesh.ndim))
    else:
        x = params["tok_embed"][tokens]
    if frontend_embeds is not None:
        fe = frontend_embeds.to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
    return constrain(x, "batch", "seq", "embed")


def lm_logits(params, x, cfg: ModelConfig):
    w = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        # mask padded vocab entries so argmax/softmax never pick them; out
        # of place, so autograd sees the mask
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return constrain(logits, "batch", "seq", "vocab")


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean next-token CE in float32. logits [B,S,V], labels [B,S] int;
    with ``mask`` [B,S], the mean over the positions it weights."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # the gather on 2-D views selects the same elements; DTensor's
    # vocab-sharded gather takes only a 2-D index, and its masked partial
    # sum must be reduced in the gather's own shape (before any reshape)
    gold = torch.gather(logits.reshape(-1, logits.shape[-1]), -1,
                        labels.reshape(-1, 1).long())
    nll = (logz.reshape(-1, 1) - gold).reshape(labels.shape)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()

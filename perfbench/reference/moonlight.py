"""Plain reference of Moonlight-16B-A3B (DeepSeek-V3 blocks), for serving.

Embedding → n_layers × (RMSNorm → latent attention → residual, RMSNorm →
dense SwiGLU (the leading ``first_dense`` layers) or mixture of experts →
residual) → RMSNorm → untied head. Written from the published layer
equations in plain PyTorch, float32 throughout (TF32 off), with none of
the program's code. For x the normed input at positions ``pos``:

- latent attention, no query LoRA: q = x·W_q [H, nope + rope], q_pe =
  RoPE(q[nope:]); [c, k_pe] = x·W_kva; c = RMSNorm_kv(c); k_pe = RoPE(k_pe),
  one head shared by all H; [k_nope, v] = c·W_kvb; k = [k_nope, k_pe];
  o = softmax(q·kᵀ · (nope + rope)^-0.5, causal)·v; out = o·W_o. Only
  this expanded form: the program's decode, which absorbs W_kvb into the
  query and attends over the latent, is held against it. RoPE rotates
  interleaved pairs, θ ``rope_theta``; attention in blocks of ``CHUNK``
  queries.
- mixture of experts: s = sigmoid(x·W_r) (float32); the top k of s + b
  (ties to the lower index); gates s[chosen] / Σ s[chosen] · the routed
  scale; y = Σ_k g_k·Expert_k(x) + Shared(x), every expert SwiGLU; each
  (token, choice) pair computed, gathered expert by expert by index: no
  capacity, nothing dropped.

Weights are the benchmark's own, made from the seed in the program's
parameter layout (``make_params``; one generator a leaf, as
``transformer.py``): every layer its own ``posNN`` (one group of
``n_layers``), each leaf with a leading axis of 1. The reference keeps the
stored (bf16) leaves and reads one layer's as float32 when it uses them.

``quant`` computes the control one precision below the configuration's
(``control_for``), as ``transformer.py`` does: every weight and activation
product takes its operands rounded to float8 e4m3 under a per-tensor
scale (bf16 for a float32 configuration). The router stays float32. The
file stands alone (its weights and precision helpers are
``transformer.py``'s, copied), so it loads by file path.
"""
from __future__ import annotations

import contextlib
import zlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

CHUNK = 1024
# the selection bias's scale: drawn non-zero, so that biased and unbiased
# selection differ (the published model's trained bias is not known here)
BIAS_SCALE = 0.1


@dataclass(frozen=True)
class Sizes:
    d: int
    L: int
    H: int
    r: int
    nope: int
    rope: int
    v: int
    ff: int
    dense_layers: int
    E: int
    k: int
    f: int
    shared: int
    routed_scale: float
    V: int
    Vp: int
    eps: float
    theta: float
    dtype: torch.dtype

    @property
    def qk(self) -> int:
        return self.nope + self.rope


def sizes(cfg: dict) -> Sizes:
    """``cfg``: a configuration file's ``model`` dict."""
    a, m = cfg.get("mla") or {}, cfg.get("moe") or {}
    if not a.get("kv_lora_rank") or m.get("scoring") != "sigmoid":
        raise ValueError("this reference holds latent attention with "
                         "sigmoid-routed experts (DeepSeek-V3 blocks)")
    if cfg.get("scan_period") != cfg["n_layers"] or cfg.get("tie_embeddings"):
        raise ValueError("this reference holds one group of n_layers "
                         "(scan_period = n_layers) and an untied head")
    if m.get("every", 1) != 1 or not m.get("dense_residual") or \
            not m.get("selection_bias"):
        raise ValueError("this reference holds an MoE FFN in every layer "
                         "after the dense ones, with shared experts, "
                         "renormalised gates and a selection bias")
    V = int(cfg["vocab_size"])
    return Sizes(
        d=cfg["d_model"], L=cfg["n_layers"], H=cfg["n_heads"],
        r=a["kv_lora_rank"], nope=a["qk_nope_head_dim"],
        rope=a["qk_rope_head_dim"], v=a["v_head_dim"], ff=cfg["d_ff"],
        dense_layers=int(m.get("first_dense", 0)), E=int(m["n_experts"]),
        k=int(m["top_k"]), f=int(m["d_expert"]),
        shared=int(m["d_dense_residual"]),
        routed_scale=float(m.get("routed_scale", 1.0)), V=V,
        Vp=-(-V // 256) * 256, eps=cfg.get("norm_eps", 1e-5),
        theta=cfg.get("rope_theta", 1e4),
        dtype=_DTYPES[cfg.get("dtype", "bfloat16")])


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _swiglu_specs(prefix: str, d: int, f: int, w, lead=(1,), extra=()):
    e = tuple(extra)
    return {prefix + "w_up": (lead + e + (d, f), w, d ** -0.5),
            prefix + "w_gate": (lead + e + (d, f), w, d ** -0.5),
            prefix + "w_down": (lead + e + (f, d), w, f ** -0.5)}


def param_specs(sz: Sizes) -> Dict[str, Tuple[tuple, torch.dtype, float]]:
    """{path: (shape, dtype, init)}: init is the normal's scale, or 0 for
    a norm scale (ones)."""
    d, H, w, f32 = sz.d, sz.H, sz.dtype, torch.float32
    out = {"embed/tok_embed": ((sz.Vp, d), w, 0.02),
           "embed/lm_head": ((d, sz.Vp), w, d ** -0.5)}
    for layer in range(sz.L):
        blk = f"stack/pos{layer:02d}/"
        out[blk + "mixer_norm/scale"] = ((1, d), f32, 0.0)
        out[blk + "mixer/wq"] = ((1, d, H, sz.qk), w, d ** -0.5)
        out[blk + "mixer/wkv_a"] = ((1, d, sz.r + sz.rope), w, d ** -0.5)
        out[blk + "mixer/kv_norm/scale"] = ((1, sz.r), f32, 0.0)
        out[blk + "mixer/wkv_b"] = ((1, sz.r, H, sz.nope + sz.v), w,
                                    sz.r ** -0.5)
        out[blk + "mixer/wo"] = ((1, H, sz.v, d), w, (H * sz.v) ** -0.5)
        out[blk + "ffn_norm/scale"] = ((1, d), f32, 0.0)
        if layer < sz.dense_layers:
            out.update(_swiglu_specs(blk + "ffn/", d, sz.ff, w))
            continue
        out[blk + "moe/router"] = ((1, d, sz.E), f32, d ** -0.5)
        out.update(_swiglu_specs(blk + "moe/experts/", d, sz.f, w,
                                 extra=(sz.E,)))
        out[blk + "moe/router_bias"] = ((1, sz.E), f32, BIAS_SCALE)
        out.update(_swiglu_specs(blk + "moe/dense/", d, sz.shared, w))
    out["stack/final_norm/scale"] = ((d,), f32, 0.0)
    return out


def leaf_seed(seed: int, path: str) -> int:
    """A generator seed of (seed, path), under 2**63 (as
    ``transformer.py``'s)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(path.encode())) \
        & ((1 << 64) - 1)
    return mixed >> 1


def make_leaf(cfg: dict, seed: int, path: str, device) -> torch.Tensor:
    """Leaf ``path`` from the seed, on ``device``, in its stored dtype:
    one float32 normal of the whole leaf, scaled, rounded once."""
    shape, dtype, scale = param_specs(sizes(cfg))[path]
    if scale == 0.0:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    t = torch.randn(shape, generator=gen, device=device)
    return t.mul_(scale).to(dtype)


def make_params(cfg: dict, seed: int, device) -> dict:
    """Every leaf from the seed, as the program's nested parameter dict."""
    tree: dict = {}
    for path in param_specs(sizes(cfg)):
        *dirs, last = path.split("/")
        node = tree
        for p in dirs:
            node = node.setdefault(p, {})
        node[last] = make_leaf(cfg, seed, path, device)
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# Precision: float32 without TF32, and the control
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def float32_exact():
    """float32 products in full float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale that takes its
    largest magnitude to the format's largest value; back in float32."""
    fmt = torch.float8_e4m3fn
    amax = x.abs().amax().float().clamp_min(1e-30)
    s = torch.finfo(fmt).max / amax
    return (x.float() * s).to(fmt).float() / s


_ROUND = {"fp8": fp8_round, "bf16": lambda x: x.to(torch.bfloat16).float()}
# the control of each stated dtype: the nearest precision below it
CONTROL = {"bfloat16": "fp8", "float16": "fp8", "float32": "bf16"}


def control_for(cfg: dict) -> str:
    """The precision of the control for a configuration's dtype."""
    return CONTROL[cfg.get("dtype", "bfloat16")]


def _q(x, quant):
    return x if quant is None else _ROUND[quant](x)


def mm(a, b, quant=None):
    """a [..., K] @ b [K, N], the operands rounded to ``quant``."""
    return _q(a, quant) @ _q(b, quant)


def einsum(eq, a, b, quant=None):
    return torch.einsum(eq, _q(a, quant), _q(b, quant))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta: float):
    """x [S, heads, n]: interleaved pairs (x[..., 0::2], x[..., 1::2])
    rotated by pos · theta^(-2i/n)."""
    n = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, n, 2, device=x.device,
                                       dtype=torch.float32) / n)
    ang = pos.float()[:, None] * inv                          # [S, n/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).flatten(-2)


def latent_attention(x, w, sz: Sizes, quant=None):
    """x [S, d] normed, at positions 0 .. S-1 -> [S, d]: the expanded
    form, causal."""
    S, H = x.shape[0], sz.H
    pos = torch.arange(S, device=x.device)
    q = mm(x, w("mixer/wq").reshape(sz.d, -1), quant).reshape(S, H, sz.qk)
    q = torch.cat([q[..., :sz.nope], rope(q[..., sz.nope:], pos, sz.theta)],
                  dim=-1)
    kva = mm(x, w("mixer/wkv_a"), quant)
    c = rmsnorm(kva[:, :sz.r], w("mixer/kv_norm/scale"), sz.eps)
    k_pe = rope(kva[:, None, sz.r:], pos, sz.theta)           # [S, 1, rope]
    kv = mm(c, w("mixer/wkv_b").reshape(sz.r, -1), quant).reshape(
        S, H, sz.nope + sz.v)
    k = torch.cat([kv[..., :sz.nope], k_pe.expand(S, H, sz.rope)], dim=-1)
    v = kv[..., sz.nope:]
    outs = []
    for s0 in range(0, S, CHUNK):
        s1 = min(S, s0 + CHUNK)
        sc = einsum("qhd,thd->hqt", q[s0:s1], k[:s1], quant) * sz.qk ** -0.5
        mask = torch.arange(s1, device=x.device)[None, :] <= \
            torch.arange(s0, s1, device=x.device)[:, None]
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(einsum("hqt,thv->qhv", p, v[:s1], quant))
    o = torch.cat(outs, dim=0).reshape(S, H * sz.v)
    return mm(o, w("mixer/wo").reshape(H * sz.v, sz.d), quant)


def swiglu(x, up, gate, down, quant=None):
    return mm(F.silu(mm(x, gate, quant)) * mm(x, up, quant), down, quant)


def experts(x, w, sz: Sizes, quant=None):
    """x [N, d] normed -> [N, d]: sigmoid routing with the selection bias,
    every (token, choice) pair by index, plus the shared experts."""
    N = x.shape[0]
    s = torch.sigmoid(x @ w("moe/router"))                    # float32
    _, idx = torch.sort(s + w("moe/router_bias"), dim=-1, descending=True,
                        stable=True)
    idx = idx[:, :sz.k]
    g = s.gather(-1, idx)
    g = g / g.sum(-1, keepdim=True) * sz.routed_scale
    wu, wg, wd = (w("moe/experts/" + n) for n in ("w_up", "w_gate", "w_down"))
    contrib = x.new_zeros((N, sz.k, sz.d))
    for e in range(sz.E):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], wu[e], wg[e], wd[e], quant)
            contrib[tok, slot] = y * g[tok, slot, None]
    shared = swiglu(x, *(w("moe/dense/" + n)
                         for n in ("w_up", "w_gate", "w_down")), quant)
    return contrib.sum(dim=1) + shared


def hidden(get, tokens, sz: Sizes, quant=None):
    """Final-normed hidden states [S, d] of one token row [S]; ``get(path)``
    is a stored leaf, read here as float32 a layer at a time."""
    x = get("embed/tok_embed")[tokens].float()
    for layer in range(sz.L):
        blk = f"stack/pos{layer:02d}/"

        def w(name):
            return get(blk + name)[0].float()

        x = x + latent_attention(rmsnorm(x, w("mixer_norm/scale"), sz.eps),
                                 w, sz, quant)
        h = rmsnorm(x, w("ffn_norm/scale"), sz.eps)
        if layer < sz.dense_layers:
            x = x + swiglu(h, w("ffn/w_up"), w("ffn/w_gate"),
                           w("ffn/w_down"), quant)
        else:
            x = x + experts(h, w, sz, quant)
    return rmsnorm(x, get("stack/final_norm/scale").float(), sz.eps)


@torch.no_grad()
def served_logits(cfg: dict, params: dict, tokens: List[int], start: int,
                  device, quant=None) -> torch.Tensor:
    """Logits [len(tokens) - start, V] at positions start .. end of the
    sequence ``tokens``, from the stored parameters ``params``."""
    sz = sizes(cfg)
    flat = flatten(params)
    with float32_exact():
        ids = torch.as_tensor(tokens, device=device)
        x = hidden(flat.__getitem__, ids, sz, quant)[start:]
        return mm(x, flat["embed/lm_head"][:, :sz.V].float(), quant)

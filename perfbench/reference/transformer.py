"""Plain reference of the attention models the configurations name.

A decoder of ``n_layers`` blocks, each RMSNorm → causal GQA attention with
interleaved-pair RoPE → residual, then RMSNorm → SwiGLU feed-forward, dense
or top-k mixture of experts → residual; a final RMSNorm and an output head
tied to the embedding. Written from the configuration's semantics in plain
PyTorch, float32 throughout (TF32 off), with none of the program's code:

- attention: every query against the keys at or before it, in blocks of
  ``CHUNK`` queries, softmax in float32;
- mixture of experts (GShard-style, as the configuration states it):
  tokens in groups of ``min(2048, max(256, d_expert))``; the router's
  softmax, the top k (ties to the lower index), the k gates renormalised;
  each expert takes at most ``capacity = max(4, k, round(g k cf / E))``
  (at most g k) slots, which it fills in order of the choice rank first,
  then the token; a slot beyond it is dropped and its gate zeroed; each
  expert computes over its slots (gathered and scattered by index here);
  the load-balancing loss ``E w Σ_e mean(probs_e) · share(top-1 = e)``,
  averaged over groups and summed over layers;
- the loss: mean next-token cross-entropy over the real vocabulary, plus
  the load-balancing losses;
- AdamW as the configuration's trainer states it (``adamw_steps``).

Weights are the benchmark's own, made here from the seed in the
program's parameter layout (``make_params``), one generator a leaf: the
program gets them, and the reference makes them again from the seed.

``quant`` computes the control, one precision below the configuration's
(``control_for``): ``"fp8"`` for bf16, where every weight and activation
product takes its operands rounded to float8 e4m3 (per-tensor scale to
the format's largest value) and, in training, the gradient flowing into
each product rounded to float8 e5m2, the usual fp8 recipe; ``"bf16"`` for
float32, the same with bf16 roundings. The router stays float32.
"""
from __future__ import annotations

import contextlib
import math
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

CHUNK = 1024


# ---------------------------------------------------------------------------
# Sizes and the parameter layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Sizes:
    d: int
    L: int
    Hq: int
    Hkv: int
    hd: int
    ff: int
    V: int
    Vp: int
    eps: float
    theta: float
    rope_fraction: float
    window: int
    softcap: float
    E: int
    k: int
    f: int
    cf: float
    aux_w: float
    dtype: torch.dtype

    @property
    def moe(self) -> bool:
        return self.E > 0

    def group(self, tokens: int) -> int:
        g = min(min(2048, max(256, self.f)), tokens)
        if tokens % g:
            raise ValueError(f"{tokens} tokens do not split into groups of {g}")
        return g

    def capacity(self, g: int) -> int:
        return min(int(max(4, self.k, round(g * self.k * self.cf / self.E))),
                   g * self.k)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def sizes(cfg: dict) -> Sizes:
    """``cfg``: a configuration file's ``model`` dict."""
    if cfg.get("family") not in ("dense", "moe"):
        raise ValueError(f"family {cfg.get('family')!r}: this reference "
                         "holds attention models with dense or MoE FFNs")
    if cfg.get("act", "swiglu") != "swiglu" or not cfg.get("tie_embeddings"):
        raise ValueError("this reference holds SwiGLU models with a tied head")
    m = cfg.get("moe") or {}
    E = int(m.get("n_experts", 0))
    if E and (m.get("every", 1) != 1 or m.get("dense_residual")):
        raise ValueError("this reference holds an MoE FFN in every layer")
    V = int(cfg["vocab_size"])
    return Sizes(
        d=cfg["d_model"], L=cfg["n_layers"], Hq=cfg["n_heads"],
        Hkv=cfg["n_kv_heads"],
        hd=cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"],
        ff=cfg["d_ff"], V=V, Vp=-(-V // 256) * 256,
        eps=cfg.get("norm_eps", 1e-5), theta=cfg.get("rope_theta", 1e4),
        rope_fraction=cfg.get("rope_fraction", 1.0),
        window=cfg.get("sliding_window", 0),
        softcap=cfg.get("attn_logit_softcap", 0.0),
        E=E, k=int(m.get("top_k", 0)), f=int(m.get("d_expert", 0)),
        cf=float(m.get("capacity_factor", 1.25)),
        aux_w=float(m.get("aux_loss_weight", 0.01)),
        dtype=_DTYPES[cfg.get("dtype", "bfloat16")])


def param_specs(sz: Sizes) -> Dict[str, Tuple[tuple, torch.dtype, float]]:
    """{path: (shape, dtype, init)}: init is the normal's scale, or 0 for
    a norm scale (ones). Layers are stacked on a leading axis."""
    L, d, hd = sz.L, sz.d, sz.hd
    w = sz.dtype
    out = {"embed/tok_embed": ((sz.Vp, d), w, 0.02)}
    blk = "stack/pos00/"
    out[blk + "mixer_norm/scale"] = ((L, d), torch.float32, 0.0)
    out[blk + "mixer/wq"] = ((L, d, sz.Hq, hd), w, d ** -0.5)
    out[blk + "mixer/wk"] = ((L, d, sz.Hkv, hd), w, d ** -0.5)
    out[blk + "mixer/wv"] = ((L, d, sz.Hkv, hd), w, d ** -0.5)
    out[blk + "mixer/wo"] = ((L, sz.Hq, hd, d), w, (sz.Hq * hd) ** -0.5)
    out[blk + "ffn_norm/scale"] = ((L, d), torch.float32, 0.0)
    if sz.moe:
        out[blk + "moe/router"] = ((L, d, sz.E), torch.float32, d ** -0.5)
        for name, shape, scale in (("w_up", (sz.E, d, sz.f), d ** -0.5),
                                   ("w_gate", (sz.E, d, sz.f), d ** -0.5),
                                   ("w_down", (sz.E, sz.f, d), sz.f ** -0.5)):
            out[blk + "moe/experts/" + name] = ((L,) + shape, w, scale)
    else:
        for name, shape, scale in (("w_up", (d, sz.ff), d ** -0.5),
                                   ("w_gate", (d, sz.ff), d ** -0.5),
                                   ("w_down", (sz.ff, d), sz.ff ** -0.5)):
            out[blk + "ffn/" + name] = ((L,) + shape, w, scale)
    out["stack/final_norm/scale"] = ((d,), torch.float32, 0.0)
    return out


def leaf_seed(seed: int, path: str) -> int:
    """A generator seed of (seed, path), under 2**63."""
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


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *dirs, last = path.split("/")
        for p in dirs:
            node = node.setdefault(p, {})
        node[last] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """Every leaf from the seed, as the program's nested parameter dict."""
    return nest({p: make_leaf(cfg, seed, p, device)
                 for p in param_specs(sizes(cfg))})


# ---------------------------------------------------------------------------
# Precision: float32 without TF32, and the fp8 control
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


def fp8_round(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to ``fmt`` under one per-tensor scale that takes its
    largest magnitude to the format's largest value; back in float32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    s = torch.finfo(fmt).max / amax
    return (x.float() * s).to(fmt).float() / s


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


# the control of each stated dtype: the nearest precision below it
CONTROL = {"bfloat16": "fp8", "float16": "fp8", "float32": "bf16"}
_OPERAND = {"fp8": fp8_round, "bf16": bf16_round}
_GRAD = {"fp8": lambda g: fp8_round(g, torch.float8_e5m2),
         "bf16": bf16_round}


def control_for(cfg: dict) -> str:
    """The precision of the control for a configuration's dtype."""
    return CONTROL[cfg.get("dtype", "bfloat16")]


class _GradRound(torch.autograd.Function):
    """Identity forward; the gradient rounded to ``quant``'s gradient
    format backward (fp8 e5m2, or bf16)."""

    @staticmethod
    def forward(ctx, x, quant):
        ctx.quant = quant
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _GRAD[ctx.quant](g), None


def _qin(x, quant):
    if quant is None:
        return x
    q = _OPERAND[quant](x)
    return x + (q - x).detach() if x.requires_grad else q   # straight through


def _qout(y, quant):
    return _GradRound.apply(y, quant) if quant is not None and \
        y.requires_grad else y


def mm(a, b, quant=None):
    """a [..., K] @ b [K, N]."""
    return _qout(_qin(a, quant) @ _qin(b, quant), quant)


def einsum(eq, a, b, quant=None):
    return _qout(torch.einsum(eq, _qin(a, quant), _qin(b, quant)), quant)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, sz: Sizes):
    """Interleaved pairs (x[..., 0::2], x[..., 1::2]) of the leading
    ``rope_fraction`` of the head rotated by pos · theta^(-2i/rot)."""
    rot = int(sz.hd * sz.rope_fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = 1.0 / sz.theta ** (torch.arange(0, rot, 2, device=x.device,
                                          dtype=torch.float32) / rot)
    ang = pos.float()[:, None] * inv                      # [S, rot/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                      dim=-1).flatten(-2)
    return torch.cat([out, x[..., rot:]], dim=-1) if rot < sz.hd else out


def attention(q, k, v, sz: Sizes, quant=None):
    """q [b,S,Hq,hd] at positions T-S .. T-1; k, v [b,T,Hkv,hd]."""
    b, S, Hq, hd = q.shape
    T, G = k.shape[1], Hq // sz.Hkv
    qg = q.reshape(b, S, sz.Hkv, G, hd)
    outs = []
    for s0 in range(0, S, CHUNK):
        n = min(CHUNK, S - s0)
        top = T - S + s0 + n                      # keys this block can see
        qpos = torch.arange(T - S + s0, top, device=q.device)
        kpos = torch.arange(top, device=q.device)
        sc = einsum("bqkgh,btkh->bkgqt", qg[:, s0:s0 + n], k[:, :top],
                    quant) * hd ** -0.5
        if sz.softcap > 0:
            sc = torch.tanh(sc / sz.softcap) * sz.softcap
        mask = kpos[None, :] <= qpos[:, None]
        if sz.window > 0:
            mask &= kpos[None, :] > qpos[:, None] - sz.window
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        o = einsum("bkgqt,btkh->bqkgh", p, v[:, :top], quant)
        outs.append(o.reshape(b, n, Hq, hd))
    return torch.cat(outs, dim=1)


def moe(x, router, wu, wg, wd, sz: Sizes, quant=None):
    """x [N, d] (whole groups) -> (out [N, d], sum over groups of the
    load-balancing loss)."""
    N, d = x.shape
    g = sz.group(N)
    n, E, k = N // g, sz.E, sz.k
    xg = x.reshape(n, g, d)
    probs = torch.softmax(xg @ router, dim=-1)                    # [n,g,E]
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = sz.capacity(g)
    # each slot's place in its expert: rank-major order, then token order
    e_rank = idx.transpose(1, 2).reshape(n, k * g)
    oh = F.one_hot(e_rank, E)
    place = (oh.cumsum(1) - oh).gather(-1, e_rank[..., None])[..., 0]
    place = place.reshape(n, k, g).transpose(1, 2)                # [n,g,k]
    keep = place < cap
    gates = vals * keep
    gi, ti, _ = torch.nonzero(keep, as_tuple=True)
    ei, pi = idx[keep], place[keep]
    slots = torch.zeros((n, E, cap, d), dtype=x.dtype, device=x.device)
    slots = slots.index_put((gi, ei, pi), xg[gi, ti])
    h = F.silu(einsum("necd,edf->necf", slots, wg, quant)) * einsum(
        "necd,edf->necf", slots, wu, quant)
    y = einsum("necf,efd->necd", h, wd, quant)
    contrib = y[gi, ei, pi] * gates[keep][:, None]
    out = torch.zeros((n, g, d), dtype=x.dtype, device=x.device)
    out = out.index_put((gi, ti), contrib, accumulate=True)
    share = F.one_hot(idx[..., 0], E).float().mean(1)             # [n,E]
    aux = (probs.mean(1) * share).sum() * E * sz.aux_w
    return out.reshape(N, d), aux


def hidden(get: Callable, tokens, sz: Sizes, quant=None):
    """Final-normed hidden states [b, S, d] of token rows [b, S] and the
    load-balancing losses summed over layers and groups. ``get(path)`` is
    a stored leaf (stacked over layers), read here as float32 a layer at
    a time; each stacked leaf is split once (``unbind``), so its gradient
    is stacked once."""
    b, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = get("embed/tok_embed")[tokens].float()
    aux = x.new_zeros(())
    blk = "stack/pos00/"
    split: Dict[str, tuple] = {}

    def w(name, l):
        if name not in split:
            split[name] = torch.unbind(get(blk + name))
        return split[name][l].float()

    for l in range(sz.L):
        h = rmsnorm(x, w("mixer_norm/scale", l), sz.eps)
        q = mm(h, w("mixer/wq", l).reshape(sz.d, -1), quant)
        kk = mm(h, w("mixer/wk", l).reshape(sz.d, -1), quant)
        vv = mm(h, w("mixer/wv", l).reshape(sz.d, -1), quant)
        q = rope(q.reshape(b, S, sz.Hq, sz.hd), pos, sz)
        kk = rope(kk.reshape(b, S, sz.Hkv, sz.hd), pos, sz)
        vv = vv.reshape(b, S, sz.Hkv, sz.hd)
        o = attention(q, kk, vv, sz, quant).reshape(b, S, sz.Hq * sz.hd)
        x = x + mm(o, w("mixer/wo", l).reshape(-1, sz.d), quant)
        h = rmsnorm(x, w("ffn_norm/scale", l), sz.eps)
        if sz.moe:
            out, a = moe(h.reshape(b * S, sz.d), w("moe/router", l),
                         w("moe/experts/w_up", l), w("moe/experts/w_gate", l),
                         w("moe/experts/w_down", l), sz, quant)
            x = x + out.reshape(b, S, sz.d)
            aux = aux + a
        else:
            x = x + mm(F.silu(mm(h, w("ffn/w_gate", l), quant))
                       * mm(h, w("ffn/w_up", l), quant),
                       w("ffn/w_down", l), quant)
    final = get("stack/final_norm/scale").float()
    return rmsnorm(x, final, sz.eps), aux


def head(x, get, sz: Sizes, quant=None):
    """Logits over the real vocabulary."""
    return mm(x, get("embed/tok_embed")[:sz.V].float().T, quant)


# ---------------------------------------------------------------------------
# Serving: logits at the positions that produced served tokens
# ---------------------------------------------------------------------------

@torch.no_grad()
def served_logits(cfg: dict, params: dict, tokens: List[int], start: int,
                  device, quant=None) -> torch.Tensor:
    """Logits [len(tokens) - start, V] at positions start .. end of the
    sequence ``tokens``, from the stored parameters ``params``."""
    sz = sizes(cfg)
    flat = flatten(params)
    with float32_exact():
        ids = torch.as_tensor(tokens, device=device)[None]
        x, _ = hidden(flat.__getitem__, ids, sz, quant)
        return head(x[0, start:], flat.__getitem__, sz, quant)


# ---------------------------------------------------------------------------
# Training: the loss, the gradient and AdamW, step for step
# ---------------------------------------------------------------------------

def cosine_lr(base: float, warmup: int, total: int, step: int,
              min_ratio: float = 0.1) -> float:
    """Linear warm-up to ``base``, then a cosine to min_ratio · base at
    ``total`` steps."""
    warm = min(step / max(warmup, 1), 1.0)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * warm * (min_ratio + (1 - min_ratio) * 0.5
                          * (1 + math.cos(math.pi * frac)))


def adamw_steps(cfg: dict, seed: int, mix: dict, batches: Iterable[dict],
                device, quant=None, rows: Optional[int] = None,
                block_rows: int = 1) -> dict:
    """Follow the trainer from the seed's weights over ``batches``.

    Each step: the loss (mean token cross-entropy plus the load-balancing
    losses) and its gradient over the first ``rows`` rows (all by
    default), summed over blocks of ``block_rows`` rows; the gradient
    clipped to ``grad_clip`` global norm; m and v in float32; the update
    ``m̂ / (sqrt(v̂) + eps)`` plus ``weight_decay · p`` on leaves of two or
    more dimensions, at the cosine schedule's rate for the new step; each
    parameter computed in float32 and stored in its own dtype.

    Returns {"loss": [per step], "grad_norm": {path: norm of the first
    clipped gradient}, "change_norm": {path: norm of the parameters'
    change over all the steps}}."""
    sz = sizes(cfg)
    specs = param_specs(sz)
    adam = mix["adamw"]
    b1, b2, eps = adam["b1"], adam["b2"], adam["eps"]
    p = {path: make_leaf(cfg, seed, path, device).float().requires_grad_()
         for path in specs}
    paths = list(p)
    m = {path: torch.zeros_like(t) for path, t in p.items()}
    v = {path: torch.zeros_like(t) for path, t in p.items()}
    out = {"loss": [], "grad_norm": {}, "change_norm": {}}

    def get(path):
        return p[path]

    with float32_exact():
        for t, batch in enumerate(batches, start=1):
            tokens, labels = batch["tokens"].long(), batch["labels"].long()
            B, S = tokens.shape
            R = rows or B
            block_rows = min(block_rows, R)
            grads = {path: torch.zeros_like(p[path]) for path in paths}
            groups = 1
            if sz.moe:
                g = sz.group(R * S)
                if sz.group(block_rows * S) != g:
                    raise ValueError(f"blocks of {block_rows} rows split "
                                     f"the MoE groups of {g} tokens")
                groups = R * S // g
            total = 0.0
            for r0 in range(0, R, block_rows):
                r1 = min(R, r0 + block_rows)
                x, aux = hidden(get, tokens[r0:r1], sz, quant)
                logits = head(x, get, sz, quant)
                lab = labels[r0:r1]
                ce = (torch.logsumexp(logits, -1)
                      - logits.gather(-1, lab[..., None])[..., 0]).sum()
                loss = ce / (R * S) + aux / groups
                gs = torch.autograd.grad(loss, [p[q] for q in paths],
                                         allow_unused=True)
                for q, gq in zip(paths, gs):
                    if gq is not None:
                        grads[q] += gq
                total += float(loss.detach())
                del x, aux, logits, loss, gs
            out["loss"].append(total)
            with torch.no_grad():
                gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
                scale = torch.clamp_max(mix["grad_clip"] / (gnorm + 1e-9), 1.0)
                lr = cosine_lr(mix["learning_rate"], mix["warmup_steps"],
                               mix["total_steps"], t)
                c1, c2 = 1 / (1 - b1 ** t), 1 / (1 - b2 ** t)
                for q in paths:
                    g = grads[q] * scale
                    if t == 1:
                        out["grad_norm"][q] = float(g.norm())
                    m[q].mul_(b1).add_(g, alpha=1 - b1)
                    v[q].mul_(b2).add_(g * g, alpha=1 - b2)
                    u = (m[q] * c1) / (torch.sqrt(v[q] * c2) + eps)
                    if p[q].dim() >= 2:
                        u = u + mix["weight_decay"] * p[q]
                    new = (p[q] - lr * u).to(specs[q][1]).float()
                    p[q].copy_(new)
                del grads
        with torch.no_grad():
            for q in paths:
                p0 = make_leaf(cfg, seed, q, device).float()
                out["change_norm"][q] = float((p[q] - p0).norm())
    return out

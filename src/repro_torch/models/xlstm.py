"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
recurrent memory mixing).

mLSTM prefill uses the stabilised parallel form (exponential input gates,
cumulative log forget gates) in key chunks with a running max, so no
[S, S] matrix is materialised; the last chunk may be shorter (the
reference needs S to be a multiple of the chunk). Decode uses the
recurrent form with (C, n, m) state.

sLSTM is sequential by construction. With ``use_kernel`` and S > 1 the
input preactivations are computed for the whole sequence, rounded to
bfloat16 as the reference's kernel path rounds them, and the recurrence
runs in ``kernels.ops.slstm_scan`` (the hand-written kernel on CUDA
tensors, its plain version on CPU tensors). Otherwise the input
projection runs inside the loop over time in float32, as the reference's
default path does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import loops
from repro_torch.kernels import ops
from repro_torch.models.layers import _normal
from repro_torch.models.ssm import causal_conv1d

MLSTM_CHUNK = 128
CONV_K = 4
_F32 = torch.float32


class _LogSigmoid(torch.autograd.Function):
    """log σ(x) written out as ATen's kernels compute it: min(x, 0) −
    log1p(z) forward, g·(1 − z/(1 + z)) for x < 0 and g·z/(1 + z)
    otherwise backward, z = exp(−|x|). DTensor has no sharding strategy for
    ``aten.log_sigmoid_backward``, and decomposes the forward only on its
    first call; these ops all have strategies (and count the same on every
    call)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_max(x, 0.0) - torch.log1p(torch.exp(-x.abs()))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        z = torch.exp(-x.abs())
        q = z / (1 + z)
        return torch.where(x < 0, 1 - q, q) * g


def _logsigmoid(x):
    """log σ(x); on a mesh (DTensor) through ``_LogSigmoid``."""
    if hasattr(x, "placements"):
        return _LogSigmoid.apply(x)
    return F.logsigmoid(x)


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    din = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    return din, din // cfg.n_heads


def slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.d_model, cfg.d_model // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen, cfg: ModelConfig, dtype, lead=()):
    lead, dev = tuple(lead), gen.device
    d = cfg.d_model
    din, _ = mlstm_dims(cfg)
    H = cfg.n_heads
    s_d, s_i = d ** -0.5, din ** -0.5
    return {
        "up_proj": _normal(lead + (d, din), s_d, dtype, gen),
        "gate_proj": _normal(lead + (d, din), s_d, dtype, gen),
        "conv_w": _normal(lead + (CONV_K, din), CONV_K ** -0.5, dtype, gen),
        "conv_b": torch.zeros(lead + (din,), dtype=dtype, device=dev),
        "wq_x": _normal(lead + (din, din), s_i, dtype, gen),
        "wk_x": _normal(lead + (din, din), s_i, dtype, gen),
        "wv_x": _normal(lead + (din, din), s_i, dtype, gen),
        "wi_x": _normal(lead + (din, H), s_i, _F32, gen),
        "wf_x": _normal(lead + (din, H), s_i, _F32, gen),
        "bi": torch.zeros(lead + (H,), dtype=_F32, device=dev),
        # bias toward remembering
        "bf": torch.full(lead + (H,), 3.0, dtype=_F32, device=dev),
        "skip_scale": torch.ones(lead + (din,), dtype=_F32, device=dev),
        "down_proj": _normal(lead + (din, d), s_i, dtype, gen),
    }


def _mlstm_parallel(q, k, v, ig, fg, chunk: int = MLSTM_CHUNK):
    """Stabilised parallel mLSTM. q,k,v: [B,H,S,dh]; ig,fg: [B,H,S] (logits).

    h_t = (Σ_{s≤t} e^{G_ts - m_t} a_ts v_s) / max(|Σ e^{G_ts - m_t} a_ts|, e^{-m_t})
    where G_ts = F_t - F_s + ĩ_s, F = cumsum(logsigmoid(f̃)), a = q·k/√dh.
    Evaluated in key chunks of ``chunk`` with a running max; the last chunk
    holds what is left of S.
    """
    B, H, S, dh = q.shape
    Fc = torch.cumsum(_logsigmoid(fg), dim=-1)        # [B,H,S]
    tpos = torch.arange(S, device=q.device)
    m = torch.full((B, H, S), -torch.inf, dtype=_F32, device=q.device)
    num = torch.zeros((B, H, S, dh), dtype=_F32, device=q.device)
    den = torch.zeros((B, H, S), dtype=_F32, device=q.device)
    # the chunks are alike when the chunk divides S (the dry run rolls them)
    n = -(-S // chunk)
    for c0 in (i * chunk for i in (loops.steps(n, q) if S % chunk == 0
                                   else range(n))):
        c1 = min(c0 + chunk, S)
        a = torch.einsum("bhtd,bhsd->bhts", q, k[:, :, c0:c1]).float()
        a = a * dh ** -0.5
        G = (Fc[..., :, None] - Fc[..., None, c0:c1]
             + ig[..., None, c0:c1])
        visible = tpos[c0:c1][None, :] <= tpos[:, None]  # [S, chunk]
        G = torch.where(visible, G, -torch.inf)
        m_new = torch.maximum(m, G.amax(dim=-1))
        scale = torch.exp(m - m_new)
        w = torch.exp(G - m_new[..., None]) * a
        num = num * scale[..., None] + torch.einsum(
            "bhts,bhsd->bhtd", w, v[:, :, c0:c1].float())
        den = den * scale + w.sum(dim=-1)
        m = m_new
    norm = torch.maximum(den.abs(), torch.exp(-m))
    return (num / norm[..., None]).to(q.dtype)


def _mlstm_recurrent_step(q, k, v, ig, fg, state):
    """One decode step. q,k,v: [B,H,1,dh]; ig,fg: [B,H,1]."""
    C, n, m = state["C"], state["n"], state["m"]
    dh = q.shape[-1]
    qs, ks, vs = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    logf = _logsigmoid(fg[..., 0])
    i = ig[..., 0]
    m_new = torch.maximum(logf + m, i)
    fs = torch.exp(logf + m - m_new)[..., None]
    is_ = torch.exp(i - m_new)[..., None]
    C = (C * fs[..., None]
         + is_[..., None] * (vs[..., :, None] * ks[..., None, :]))
    n = n * fs + is_ * ks
    num = torch.einsum("bhde,bhe->bhd", C, (qs * dh ** -0.5).float())
    den = torch.maximum((n * qs * dh ** -0.5).sum(dim=-1).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None])[:, :, None, :].to(q.dtype)
    return h, {"C": C, "n": n, "m": m_new}


def _mlstm_state_from_prefill(q, k, v, ig, fg):
    """Final (C, n, m) state after a prefill, for decode to continue from.

    Like the reference, it starts from zero whatever state came in."""
    logf = _logsigmoid(fg)
    Fc = torch.cumsum(logf, dim=-1)
    g = (Fc[..., -1:] - Fc + ig).float()   # weight of source s in the state
    m = g.amax(dim=-1)
    w = torch.exp(g - m[..., None])
    kf = k.float()
    C = torch.einsum("bhsd,bhse->bhde", w[..., None] * v.float(), kf)
    n = torch.einsum("bhs,bhsd->bhd", w, kf)
    return {"C": C, "n": n, "m": m}


def mlstm_apply(params, x, cfg: ModelConfig, state: Optional[Dict] = None,
                return_state: bool = False):
    """x: [B,S,d]. state: {"C":[B,H,dh,dh],"n":[B,H,dh],"m":[B,H],
    "conv":[B,K-1,din]}. Returns (out [B,S,d], new state or None)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    din, dh = mlstm_dims(cfg)
    u = constrain(x @ params["up_proj"], "batch", "seq", "ssm_inner")
    z = x @ params["gate_proj"]
    conv_state = state["conv"] if state is not None else None
    c, new_conv = causal_conv1d(u, params["conv_w"], params["conv_b"],
                                conv_state)
    c = F.silu(c)

    def heads(t):
        return t.reshape(B, S, H, dh).transpose(1, 2)

    q = heads(c @ params["wq_x"])
    k = heads(c @ params["wk_x"])
    v = heads(u @ params["wv_x"])
    ig = (c.float() @ params["wi_x"] + params["bi"]).transpose(1, 2)
    fg = (c.float() @ params["wf_x"] + params["bf"]).transpose(1, 2)

    new_state = None
    if state is not None and S == 1:
        h, new_state = _mlstm_recurrent_step(q, k, v, ig, fg, state)
        new_state["conv"] = new_conv.to(x.dtype)
    else:
        h = _mlstm_parallel(q, k, v, ig, fg)
        if return_state or state is not None:
            new_state = _mlstm_state_from_prefill(q, k, v, ig, fg)
            new_state["conv"] = new_conv.to(x.dtype)
    h = h.transpose(1, 2).reshape(B, S, din)
    h = h + params["skip_scale"].to(h.dtype) * c
    h = h * F.silu(z)
    return constrain(h @ params["down_proj"], "batch", "seq", "embed"), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_GATES_W = ("wi", "wf", "wz", "wo_g")
_GATES_B = ("bi", "bf", "bz", "bo")
_GATES_R = ("ri", "rf", "rz", "ro")


def slstm_init(gen, cfg: ModelConfig, dtype, lead=()):
    lead, dev = tuple(lead), gen.device
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    dff = int(cfg.xlstm.proj_factor_slstm * d)
    s = d ** -0.5
    p = {name: _normal(lead + (d, d), s, _F32, gen) for name in _GATES_W}
    for name in _GATES_R:
        # block-diagonal recurrent weights (memory mixing within heads)
        p[name] = _normal(lead + (H, dh, dh), dh ** -0.5, _F32, gen)
    for name, value in zip(_GATES_B, (0.0, 3.0, 0.0, 0.0)):
        p[name] = torch.full(lead + (d,), value, dtype=_F32, device=dev)
    p["up_proj"] = _normal(lead + (d, 2 * dff), s, dtype, gen)
    p["down_proj"] = _normal(lead + (dff, d), dff ** -0.5, dtype, gen)
    return p


def _slstm_cell(r_all, pre, carry, H):
    """One sLSTM step. pre: [B,4,d] input preactivations (i, f, z, o);
    r_all: [4,H,dh,dh]; carry: (c, n, m, h), each [B,d] float32."""
    c, n, m, h = carry
    B, _, d = pre.shape
    dh = d // H
    pre = pre.float()
    rec = torch.einsum("bhk,ghkl->gbhl", h.reshape(B, H, dh),
                       r_all).reshape(4, B, d)
    i_t = pre[:, 0] + rec[0]
    f_t = pre[:, 1] + rec[1]
    z_t = torch.tanh(pre[:, 2] + rec[2])
    o_t = torch.sigmoid(pre[:, 3] + rec[3])
    logf = _logsigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    c = c * torch.exp(logf + m - m_new) + torch.exp(i_t - m_new) * z_t
    n = n * torch.exp(logf + m - m_new) + torch.exp(i_t - m_new)
    h = o_t * c / torch.clamp_min(n, 1e-6)
    return (c, n, m_new, h)


def _gate_weights(params):
    """Input weights as one [d, 4d] matrix (gate-major columns), biases
    [4, d]."""
    w = torch.stack([params[k] for k in _GATES_W])           # [4,d,d]
    d = w.shape[1]
    b = torch.stack([params[k] for k in _GATES_B])           # [4,d]
    return w.permute(1, 0, 2).reshape(d, 4 * d), b


def _slstm_preact(params, x32):
    """Input preactivations for the whole sequence: [B,S,4,d] in bf16.

    Rounded to bf16 whatever the model's dtype, as the reference's kernel
    path does; the cell upcasts to float32."""
    w, b = _gate_weights(params)
    B, S, d = x32.shape
    return ((x32 @ w).reshape(B, S, 4, d) + b).to(torch.bfloat16)


def slstm_apply(params, x, cfg: ModelConfig, state: Optional[Dict] = None,
                return_state: bool = False, use_kernel: bool = False):
    """x: [B,S,d]. state: {"c","n","m","h"}, each [B,d] float32.
    Returns (out [B,S,d], new state or None)."""
    B, S, d = x.shape
    H = cfg.n_heads
    x32 = x.float()
    if state is None:
        carry = (x32.new_zeros((B, d)), x32.new_zeros((B, d)),
                 x32.new_full((B, d), -torch.inf), x32.new_zeros((B, d)))
    else:
        carry = (state["c"], state["n"], state["m"], state["h"])
    r_all = torch.stack([params[k] for k in _GATES_R])   # [4,H,dh,dh]

    if use_kernel and S > 1:
        dh = d // H
        pre = _slstm_preact(params, x32)
        hs, final = ops.slstm_scan(pre, r_all,
                                   *(s.reshape(B, H, dh) for s in carry))
        h = hs.to(x.dtype)
        carry = tuple(s.reshape(B, d) for s in final)
    else:
        w, b = _gate_weights(params)
        hs = []
        for t in loops.steps(S, x):
            pre_t = (x32[:, t] @ w).reshape(B, 4, d) + b   # in-loop W reads
            carry = _slstm_cell(r_all, pre_t, carry, H)
            hs.append(carry[3])
        h = torch.stack(loops.fill(hs, S), dim=1).to(x.dtype)
    # post-up-projection gated FFN (factor 4/3)
    a, g = (h @ params["up_proj"]).chunk(2, dim=-1)
    out = (F.gelu(a, approximate="tanh") * g) @ params["down_proj"]
    out = constrain(out, "batch", "seq", "embed")
    new_state = None
    if return_state or state is not None:
        new_state = dict(zip(("c", "n", "m", "h"), carry))
    return out, new_state


# ---------------------------------------------------------------------------
# States
# ---------------------------------------------------------------------------

def init_xlstm_state(cfg: ModelConfig, batch: int, kind: str, dtype,
                     device="cpu", lead=()):
    """Fresh recurrent state of one mLSTM or sLSTM layer (m at -1e30)."""
    lead = tuple(lead) + (batch,)

    def full(shape, value, dt=_F32):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    if kind == "mlstm":
        din, dh = mlstm_dims(cfg)
        H = cfg.n_heads
        return {"C": full((H, dh, dh), 0.0), "n": full((H, dh), 0.0),
                "m": full((H,), -1e30),
                "conv": full((CONV_K - 1, din), 0.0, dtype)}
    d = cfg.d_model
    return {"c": full((d,), 0.0), "n": full((d,), 0.0),
            "m": full((d,), -1e30), "h": full((d,), 0.0)}

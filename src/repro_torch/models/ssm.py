"""Mamba-1 selective-scan mixer (Jamba's SSM layers).

``selective_scan`` is the model's plain path: a chunked scan carrying the
[B, d_inner, N] float32 state from chunk to chunk, with a log-depth
(Hillis-Steele) scan over (log-decay, value) pairs inside each chunk, as
the reference's associative scan. The last chunk may be shorter, so any S
works (the reference needs S to be a multiple of the chunk). With
``use_kernel`` and S > 1, ``ssm_apply`` runs the recurrence in
``kernels.ops.ssm_scan`` instead: the hand-written kernel on CUDA tensors,
its plain version on CPU tensors. Decode (S = 1) is a scan of one step.

dtypes follow the reference: in a bfloat16 model u (the conv output), B
and C are bfloat16, while dt is float32 (``dt_bias`` is a float32 leaf and
both frameworks promote), and A, D and the state are float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import loops
from repro_torch.kernels import ops
from repro_torch.models.layers import _normal

SSM_CHUNK = 64
_F32 = torch.float32


def d_inner_of(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def dt_rank_of(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def ssm_init(gen, cfg: ModelConfig, dtype, lead=()):
    lead, dev, s = tuple(lead), gen.device, cfg.ssm
    d, din, n = cfg.d_model, d_inner_of(cfg), s.d_state
    dtr = dt_rank_of(cfg)
    # softplus^-1 of dt drawn log-uniformly in [1e-3, 1e-1]
    log_dt = (torch.rand(lead + (din,), generator=gen, device=dev)
              * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    a_log = torch.log(torch.arange(1, n + 1, dtype=_F32, device=dev))
    return {
        "in_proj": _normal(lead + (d, 2 * din), d ** -0.5, dtype, gen),
        "conv_w": _normal(lead + (s.d_conv, din), s.d_conv ** -0.5, dtype,
                          gen),
        "conv_b": torch.zeros(lead + (din,), dtype=dtype, device=dev),
        "x_dt": _normal(lead + (din, dtr), din ** -0.5, dtype, gen),
        "x_b": _normal(lead + (din, n), din ** -0.5, dtype, gen),
        "x_c": _normal(lead + (din, n), din ** -0.5, dtype, gen),
        "dt_proj": _normal(lead + (dtr, din), dtr ** -0.5, dtype, gen),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "a_log": a_log.expand(lead + (din, n)).contiguous(),
        "ssm_d": torch.ones(lead + (din,), dtype=_F32, device=dev),
        "out_proj": _normal(lead + (din, d), din ** -0.5, dtype, gen),
    }


def causal_conv1d(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [B,S,din], w: [K,din]. state: [B,K-1,din].

    Returns (y, new_state) where new_state holds the last K-1 inputs.
    """
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):] if K > 1 else torch.zeros_like(pad)
    return y, new_state


def _chunk_scan(dA, dBx, h0):
    """h_t = exp(dA_t)·h_{t-1} + dBx_t within a chunk, in log depth.

    dA, dBx: [B, L, din, N] (float32); h0: [B, din, N]. Returns (h_all,
    h_last). Step s of the Hillis-Steele scan folds each element with the
    one s before it: (la, xa) then (lb, xb) -> (la + lb, xa·e^lb + xb).
    """
    la, x = dA, dBx
    s = 1
    while s < la.shape[1]:
        x = torch.cat([x[:, :s], x[:, :-s] * torch.exp(la[:, s:]) + x[:, s:]],
                      dim=1)
        la = torch.cat([la[:, :s], la[:, :-s] + la[:, s:]], dim=1)
        s *= 2
    h_all = x + torch.exp(la) * h0[:, None]
    return h_all, h_all[:, -1]


def selective_scan(u, dt, A, B, C, D, h0=None, chunk: int = SSM_CHUNK):
    """u: [B,S,din]; dt: [B,S,din]; A: [din,N]; B,C: [B,S,N]; D: [din].

    Returns (y [B,S,din] in u's dtype, h_last [B,din,N] float32). All math
    float32.
    """
    Bb, S, din = u.shape
    N = A.shape[1]
    u32, dt32, B32, C32 = (t.to(_F32) for t in (u, dt, B, C))
    h = (u32.new_zeros((Bb, din, N)) if h0 is None else h0.to(_F32))
    ys = []
    # the chunks are alike when the chunk divides S (the dry run rolls them)
    n = -(-S // chunk)
    for c0 in (i * chunk for i in (loops.steps(n, u) if S % chunk == 0
                                   else range(n))):
        c1 = min(c0 + chunk, S)
        dtc = dt32[:, c0:c1]
        dA = dtc[..., None] * A                                # [B,L,din,N]
        dBx = (dtc * u32[:, c0:c1])[..., None] * B32[:, c0:c1, None, :]
        h_all, h = _chunk_scan(dA, dBx, h)
        ys.append(torch.einsum("blhn,bln->blh", h_all, C32[:, c0:c1]))
    y = torch.cat(loops.fill(ys, n), dim=1) + u32 * D
    return y.to(u.dtype), h


def ssm_apply(params, x, cfg: ModelConfig, state: Optional[Dict] = None,
              return_state: bool = False, use_kernel: bool = False):
    """Mamba mixer. x: [B,S,d]. state: {"conv": [B,K-1,din], "h": [B,din,N]}.

    Returns (y, new state or None).
    """
    S = x.shape[1]
    xz = constrain(x @ params["in_proj"], "batch", "seq", "ssm_inner")
    xi, z = xz.chunk(2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xi, new_conv = causal_conv1d(xi, params["conv_w"], params["conv_b"],
                                 conv_state)
    xi = F.silu(xi)

    dt_in = xi @ params["x_dt"]
    # float32: dt_bias is a float32 leaf, whatever the model's dtype
    dt = F.softplus(dt_in @ params["dt_proj"] + params["dt_bias"])
    Bm = xi @ params["x_b"]
    Cm = xi @ params["x_c"]
    A = -torch.exp(params["a_log"])
    h0 = state["h"] if state is not None else None
    if use_kernel and S > 1:
        y, h_last = ops.ssm_scan(xi, dt, A, Bm, Cm, params["ssm_d"], h0=h0)
    else:
        y, h_last = selective_scan(xi, dt, A, Bm, Cm, params["ssm_d"], h0=h0)
    y = y * F.silu(z)
    out = constrain(y @ params["out_proj"], "batch", "seq", "embed")
    new_state = None
    if return_state or state is not None:
        new_state = {"conv": new_conv.to(x.dtype), "h": h_last}
    return out, new_state


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device="cpu",
                   lead=()):
    """Fresh state of one Mamba layer: conv in the model's dtype, h float32."""
    lead = tuple(lead) + (batch,)
    din, n = d_inner_of(cfg), cfg.ssm.d_state
    return {
        "conv": torch.zeros(lead + (cfg.ssm.d_conv - 1, din), dtype=dtype,
                            device=device),
        "h": torch.zeros(lead + (din, n), dtype=_F32, device=device),
    }

"""Mamba-1 pieces of the port.

Only ``causal_conv1d`` is here so far: the mLSTM block uses it. The
selective scan and the Mamba block (``ssm_init``, ``ssm_apply``, the
decode state) come with the jamba slice (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import Optional

import torch


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

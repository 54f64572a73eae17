"""Dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version. Nothing falls back
from the kernel to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_ref, flash_kernel


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: [B,S,Hq,hd]; k,v: [B,T,Hkv,hd] -> [B,S,Hq,hd] in q's dtype."""
    if q.is_cuda:
        return flash_kernel(q, k, v, causal=causal, window=window,
                            softcap=softcap)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap)

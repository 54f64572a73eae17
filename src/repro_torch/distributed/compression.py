"""Gradient compression with error feedback, over trees of tensors.

int8 quantisation with error feedback: the residual between the true and
the quantised gradient is carried to the next step, which keeps
convergence (Seide et al. 2014; Karimireddy et al. 2019). Only leaves of
two or more dimensions and at least 4,096 elements are compressed; the
others (norms, biases) come back unchanged, with a ``None`` error. top-k
sparsification is the alternative.

Each function returns (decompressed gradients, new error): the quantise
and dequantise pair models what a compressed all-reduce would carry. The
arithmetic is the reference's, op for op, so the results are bit-equal to
it on either device. Where it divides, the divisor is a tensor on the
gradient's device: PyTorch's CUDA kernels turn a division by a Python
scalar into a product with its reciprocal, which can differ in the last
bit.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tree_lib


def _is_compressible(x: torch.Tensor) -> bool:
    return x.ndim >= 2 and x.numel() >= 4096


def init_error_state(grads) -> Any:
    """float32 zeros for each compressible leaf, ``None`` for the rest."""
    return tree_lib.map_tree(
        lambda g: (torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                   if _is_compressible(g) else None), grads)


def _compress(one, grads, error):
    if error is None:
        error = init_error_state(grads)
    out = [one(g, e) if _is_compressible(g) else (g, e) for g, e in
           zip(tree_lib.leaves(grads), tree_lib.leaves(error))]
    return (tree_lib.unflatten(grads, [g for g, _ in out]),
            tree_lib.unflatten(grads, [e for _, e in out]))


def int8_compress(grads, error: Optional[Any] = None) -> Tuple[Any, Any]:
    """Quantise each compressible leaf to int8 with one scale per tensor
    (its largest magnitude over 127), after adding the carried error.

    Returns (dequantised gradients in float32, new error)."""
    def one(g, e):
        g32 = g.to(torch.float32) + (e if e is not None else 0.0)
        scale = (torch.clamp_min(g32.abs().max(), 1e-12)
                 / g32.new_tensor(127.0))
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        return deq, g32 - deq

    return _compress(one, grads, error)


def topk_compress(grads, k_fraction: float = 0.05,
                  error: Optional[Any] = None) -> Tuple[Any, Any]:
    """Keep the largest ``k_fraction`` of each compressible leaf by
    magnitude, after adding the carried error; the dropped mass is the new
    error. k = max(int(size * k_fraction), 1); every element at least as
    large as the k-th largest magnitude is kept, so ties at the threshold
    can keep more than k."""
    def one(g, e):
        g32 = g.to(torch.float32) + (e if e is not None else 0.0)
        mag = g32.abs()
        k = max(int(mag.numel() * k_fraction), 1)
        thresh = torch.topk(mag.reshape(-1), k, sorted=False).values.min()
        kept = torch.where(mag >= thresh, g32, 0.0)
        return kept, g32 - kept

    return _compress(one, grads, error)


COMPRESSORS = {"int8": int8_compress, "topk": topk_compress}

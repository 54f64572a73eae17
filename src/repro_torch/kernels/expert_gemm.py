"""Grouped expert GEMM: the hand-written Hopper kernel and its plain
version.

``expert_gemm_ref`` is the plain PyTorch version: one einsum over float32
copies, cast to x's dtype. It is the CPU path and the yardstick the kernel
is held against. ``ExpertGemmKernel`` builds ``csrc/expert_gemm.cu`` for
``sm_90a`` at first use (``kernels/build.py``), loads it with ``ctypes``
and launches it on PyTorch's current stream, one launch for all experts,
in the body ``_body_for`` picks. ``expert_kernel.launches`` counts the
launches, ``launches_by_body`` splits them by body.

Replaces ``repro/kernels/moe_gemm.py::expert_gemm``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "expert_gemm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 65535       # the kernel's grid y (N tiles) and z (experts)
_MIN_N_TILE = 64        # the float32 body's N tile; the bf16 ones' is 128
_BODY_CODES = {"fma": 0, "mma_sync": 0, "wgmma": 1}


def _body_for(x, w) -> str:
    """Which body of the kernel takes the contiguous x [E,M,K] and w
    [E,K,N]: ``"wgmma"`` (TMA + wgmma) for bfloat16 where K and N are
    multiples of 8 (rows of 16-byte multiples, TMA's terms) and both bases
    are 16-byte aligned, else ``"mma_sync"`` for bfloat16 and ``"fma"``
    for float32. Decided from dtype, shape and alignment alone, before any
    launch."""
    if x.dtype != torch.bfloat16:
        return "fma"
    K, N = x.shape[2], w.shape[2]
    if K % 8 == 0 and N % 8 == 0 and x.data_ptr() % 16 == 0 \
            and w.data_ptr() % 16 == 0:
        return "wgmma"
    return "mma_sync"


def expert_gemm_ref(x, w):
    """x [E,M,K] @ w [E,K,N] -> [E,M,N] in x's dtype, summed in float32."""
    return torch.einsum("emk,ekn->emn", x.float(), w.float()).to(x.dtype)


class ExpertGemmKernel(KernelLibrary):
    """ctypes binding of the CUDA kernel; ``launches`` counts its launches."""

    source = SOURCE
    name = "expert_gemm"

    def _bind(self, lib) -> None:
        fn = lib.expert_gemm_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def __call__(self, x, w):
        """Launch on CUDA tensors; the shapes of ``expert_gemm_ref``."""
        _check(x, w)
        lib = self.build()
        E, M, K = x.shape
        N = w.shape[2]
        x, w = x.contiguous(), w.contiguous()
        body = _body_for(x, w)
        out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.expert_gemm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  _DTYPES[x.dtype], E, M, K, N,
                                  _BODY_CODES[body], stream)
        if err != 0:
            raise RuntimeError(f"expert_gemm_fwd ({body} body) launch "
                               f"failed: error {err} (CUDA error, or 100000 "
                               f"+ the CUresult of a refused tensor map)")
        self._count(body)
        return out


def _check(x, w):
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x {x.dtype} and w {w.dtype}: the kernel takes "
                         "both float32 or both bfloat16")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}: "
                         "want x [E,M,K] and w [E,K,N]")
    E, M, K = x.shape
    N = w.shape[2]
    if min(E, M, K, N) < 1 or E > _MAX_GRID \
            or -(-N // _MIN_N_TILE) > _MAX_GRID:
        raise ValueError(f"E={E} M={M} K={K} N={N}: want each >= 1, "
                         f"E <= {_MAX_GRID} and N <= "
                         f"{_MAX_GRID * _MIN_N_TILE}")
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("the expert GEMM kernel takes CUDA tensors only")
    if x.device != w.device:
        raise ValueError("x and w lie on different devices")


expert_kernel = ExpertGemmKernel()

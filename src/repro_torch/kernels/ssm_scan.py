"""Mamba-1 selective-scan forward: the hand-written Hopper kernel and its
plain version.

``ssm_scan_ref`` is the plain PyTorch version: a Python loop over time, all
in float32. It is the CPU path and the yardstick the kernel is held
against. ``SsmScanKernel`` builds ``csrc/ssm_scan.cu`` for ``sm_90a`` at
first use (``kernels/build.py``), loads it with ``ctypes`` and launches it
on PyTorch's current stream, one launch for all S steps.
``ssm_kernel.launches`` counts the launches, all in its one body,
``"ring"`` (chunks of u/dt/B/C double-buffered ahead of the compute).

Replaces ``repro/kernels/ssm_scan.py::ssm_scan_fwd``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
MAX_STATE = 64        # the kernel's B/C tiles hold N <= 64
_F32 = torch.float32
_IN_DTYPES = (torch.float32, torch.bfloat16)


def ssm_scan_ref(u, dt, A, B, C, D, h0=None):
    """Sequential selective scan, float32.

    u, dt: [Bb,S,d]; A: [d,N]; B,C: [Bb,S,N]; D: [d]; h0: [Bb,d,N] or None.
    Returns (y [Bb,S,d] in u's dtype, h_last [Bb,d,N] float32).
    """
    Bb, S, d = u.shape
    N = A.shape[1]
    u32, dt32, B32, C32 = (t.to(_F32) for t in (u, dt, B, C))
    A32 = A.to(_F32)
    h = (u32.new_zeros((Bb, d, N)) if h0 is None else h0.to(_F32))
    ys = []
    for t in range(S):
        dA = torch.exp(dt32[:, t, :, None] * A32)               # [Bb,d,N]
        dBx = (dt32[:, t] * u32[:, t])[..., None] * B32[:, t, None, :]
        h = h * dA + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]))
    y = torch.stack(ys, dim=1) + u32 * D.to(_F32)
    return y.to(u.dtype), h


class SsmScanKernel(KernelLibrary):
    """ctypes binding of the CUDA kernel; ``launches`` counts its launches."""

    source = SOURCE
    name = "ssm_scan"

    def _bind(self, lib) -> None:
        fn = lib.ssm_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def __call__(self, u, dt, A, B, C, D, h0=None):
        """Launch on CUDA tensors; the shapes of ``ssm_scan_ref``."""
        _check(u, dt, A, B, C, D, h0)
        lib = self.build()
        Bb, S, d = u.shape
        N = A.shape[1]
        u, dt, A, B, C, D = (t.contiguous() for t in (u, dt, A, B, C, D))
        if h0 is not None:
            h0 = h0.contiguous()
        y = torch.empty((Bb, S, d), dtype=u.dtype, device=u.device)
        h_last = torch.empty((Bb, d, N), dtype=_F32, device=u.device)
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.ssm_scan_fwd(
            *(t.data_ptr() for t in (u, dt, A, B, C, D)),
            None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), Bb, S, d, N,
            int(u.dtype == torch.bfloat16), int(dt.dtype == torch.bfloat16),
            stream)
        if err != 0:
            raise RuntimeError(f"ssm_scan_fwd launch failed: CUDA error {err}")
        self._count("ring")
        return y, h_last


def _check(u, dt, A, B, C, D, h0):
    tensors = [t for t in (u, dt, A, B, C, D, h0) if t is not None]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the selective-scan kernel takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the selective scan's inputs lie on different "
                         "devices")
    for name, t in (("u", u), ("dt", dt), ("B", B), ("C", C)):
        if t.dtype not in _IN_DTYPES:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes float32 "
                             "or bfloat16")
    if B.dtype != u.dtype or C.dtype != u.dtype:
        raise ValueError(f"B {B.dtype} and C {C.dtype} must be in u's dtype "
                         f"{u.dtype}")
    for name, t in (("A", A), ("D", D), ("h0", h0)):
        if t is not None and t.dtype != _F32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError(f"shapes u {tuple(u.shape)}, A {tuple(A.shape)}: "
                         "want u [Bb,S,d] and A [d,N]")
    Bb, S, d = u.shape
    N = A.shape[1]
    want = {"dt": (dt, (Bb, S, d)), "A": (A, (d, N)), "B": (B, (Bb, S, N)),
            "C": (C, (Bb, S, N)), "D": (D, (d,)), "h0": (h0, (Bb, d, N))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, want {shape}")
    if S < 1 or d < 1 or not 1 <= Bb <= 65535:
        raise ValueError(f"u {tuple(u.shape)}: want S >= 1, d >= 1 and "
                         "1 <= Bb <= 65535")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size {N} not in [1, {MAX_STATE}]")


ssm_kernel = SsmScanKernel()

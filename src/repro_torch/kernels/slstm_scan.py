"""sLSTM scan forward: the hand-written Hopper kernel and its plain version.

``slstm_scan_ref`` is the plain PyTorch version: a Python loop over time of
the sLSTM cell, all in float32. It is the CPU path and the yardstick the
kernel is held against. ``SlstmScanKernel`` builds ``csrc/slstm_scan.cu``
for ``sm_90a`` at first use (``kernels/build.py``), loads it with
``ctypes`` and launches it on PyTorch's current stream, one cooperative
launch for all S steps, in its one body, ``"regs"`` (R in registers, h
exchanged between blocks as tagged words). ``slstm_kernel.launches``
counts the launches.

Replaces ``repro/kernels/slstm_scan.py::slstm_scan_fwd``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm_scan.cu"
MAX_HEAD_DIM = 512     # a lane's R slice fills half its registers
MAX_BATCH = 32         # one state-owning lane per (batch row, column)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def slstm_scan_ref(pre, r_all, c0, n0, m0, h0):
    """pre: [B,S,4,d] preactivations (i, f, z, o); r_all: [4,H,dh,dh];
    c0/n0/m0/h0: [B,H,dh]. Returns (hs [B,S,d] in pre's dtype,
    (cT, nT, mT, hT) [B,H,dh] float32)."""
    B, S, _, d = pre.shape
    H, dh = r_all.shape[1], r_all.shape[2]
    r = r_all.float()
    c, n, m, h = (s.float() for s in (c0, n0, m0, h0))
    pre_h = pre.float().reshape(B, S, 4, H, dh)
    hs = []
    for t in range(S):
        rec = torch.einsum("bhk,ghkl->gbhl", h, r)
        p = pre_h[:, t]
        i = p[:, 0] + rec[0]
        f = p[:, 1] + rec[1]
        z = torch.tanh(p[:, 2] + rec[2])
        o = torch.sigmoid(p[:, 3] + rec[3])
        logf = F.logsigmoid(f)
        m_new = torch.maximum(logf + m, i)
        scale = torch.exp(logf + m - m_new)
        inp = torch.exp(i - m_new)
        c = c * scale + inp * z
        n = n * scale + inp
        h = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(B, S, d).to(pre.dtype)
    return hs, (c, n, m, h)


class SlstmScanKernel(KernelLibrary):
    """ctypes binding of the CUDA kernel; ``launches`` counts its launches."""

    source = SOURCE
    name = "slstm_scan"

    def _bind(self, lib) -> None:
        fn = lib.slstm_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def __call__(self, pre, r_all, c0, n0, m0, h0):
        """Launch on CUDA tensors; the shapes of ``slstm_scan_ref``."""
        _check(pre, r_all, c0, n0, m0, h0)
        lib = self.build()
        B, S, _, d = pre.shape
        H, dh = r_all.shape[1], r_all.shape[2]
        dev = pre.device
        pre, r_all, c0, n0, m0, h0 = (
            t.contiguous() for t in (pre, r_all, c0, n0, m0, h0))
        hs = torch.empty((B, S, d), dtype=pre.dtype, device=dev)
        cT, nT, mT, hT = (torch.empty((B, H, dh), dtype=torch.float32,
                                      device=dev) for _ in range(4))
        # h's exchange between blocks: tagged words, starting at tag 0
        xchg = torch.zeros((2, B, H, dh), dtype=torch.int64, device=dev)
        info = (ctypes.c_int * 3)()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.slstm_scan_fwd(
            *(t.data_ptr() for t in (pre, r_all, c0, n0, m0, h0, hs, cT, nT,
                                     mT, hT, xchg)),
            _DTYPE_CODES[pre.dtype], B, S, H, dh, info, stream)
        if err == -1:
            raise RuntimeError(
                f"slstm_scan: a grid of {info[2]} blocks cannot be "
                f"co-resident ({info[0]} per SM on {info[1]} SMs)")
        if err != 0:
            raise RuntimeError(f"slstm_scan_fwd launch failed: CUDA error "
                               f"{err}")
        self._count("regs")
        return hs, (cT, nT, mT, hT)


def _check(pre, r_all, c0, n0, m0, h0):
    tensors = (pre, r_all, c0, n0, m0, h0)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the sLSTM scan kernel takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the sLSTM scan's inputs lie on different devices")
    if pre.dtype not in _DTYPE_CODES:
        raise ValueError(f"pre is {pre.dtype}: the kernel takes float32 or "
                         "bfloat16")
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise ValueError("R and the c/n/m/h states must be float32")
    if pre.dim() != 4 or pre.shape[2] != 4 or r_all.dim() != 4:
        raise ValueError(f"shapes {tuple(pre.shape)}, {tuple(r_all.shape)}: "
                         "want pre [B,S,4,d] and R [4,H,dh,dh]")
    B, S, _, d = pre.shape
    _, H, dh, dh2 = r_all.shape
    if r_all.shape[0] != 4 or dh != dh2 or H * dh != d:
        raise ValueError(f"R {tuple(r_all.shape)} does not fit pre "
                         f"{tuple(pre.shape)}")
    for t in tensors[2:]:
        if tuple(t.shape) != (B, H, dh):
            raise ValueError(f"state {tuple(t.shape)}, want {(B, H, dh)}")
    if S < 1:
        raise ValueError("the sLSTM scan needs S >= 1")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batch {B} not in [1, {MAX_BATCH}]")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} not in [1, {MAX_HEAD_DIM}]")


slstm_kernel = SlstmScanKernel()

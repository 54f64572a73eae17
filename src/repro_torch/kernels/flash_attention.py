"""Flash attention forward: the hand-written Hopper kernel and its plain version.

``flash_attention_ref`` is the plain PyTorch version (full materialisation,
float32 math): the CPU path and the yardstick the kernel is held against.
``FlashAttentionKernel`` builds ``csrc/flash_attention.cu`` for ``sm_90a``
at first use (``kernels/build.py``), loads it with ``ctypes`` and launches
it on PyTorch's current stream, in the body ``_body_for`` picks.
``flash_kernel.launches`` counts the launches, ``launches_by_body`` splits
them by body.

Replaces ``repro/kernels/flash_attention.py::flash_attention_fwd``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary, bind_context

NEG_INF = -2.3819763e38

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BODY_CODES = {"fma": 0, "mma_sync": 0, "wgmma": 1}


def _body_for(q, k, v) -> str:
    """Which body of the kernel takes these tensors: ``"wgmma"`` (TMA +
    wgmma) for bfloat16 at head dims 64 and 128 where there is at least
    one key, every base is 16-byte aligned and every stride a positive
    multiple of 16 bytes (TMA's terms), else ``"mma_sync"`` for bfloat16
    and ``"fma"`` for float32. Decided from dtype, shape and strides
    alone, before any launch."""
    if q.dtype != torch.bfloat16:
        return "fma"
    if q.shape[3] in WGMMA_HEAD_DIMS and k.shape[1] > 0 and all(
            t.data_ptr() % 16 == 0 and all(st > 0 and st % 8 == 0
                                           for st in t.stride()[:3])
            for t in (q, k, v)):
        return "wgmma"
    return "mma_sync"


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """q: [B,S,Hq,hd]; k,v: [B,T,Hkv,hd] -> [B,S,Hq,hd] in q's dtype.

    Causal (query i sees keys j <= i), optionally sliding-window (also
    j > i - window) and softcapped; GQA: kv head = q head // (Hq/Hkv).
    """
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd).float()
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * hd ** -0.5
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, Hq, hd).to(q.dtype)


class FlashAttentionKernel(KernelLibrary):
    """ctypes binding of the CUDA kernel; ``launches`` counts its launches."""

    source = SOURCE
    name = "flash_attention"

    def _bind(self, lib) -> None:
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def __call__(self, q, k, v, causal: bool = True, window: int = 0,
                 softcap: float = 0.0):
        """Launch on CUDA tensors q [B,S,Hq,hd], k/v [B,T,Hkv,hd]."""
        _check(q, k, v)
        lib = self.build()
        B, S, Hq, hd = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        out = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
        if out.numel() == 0:
            return out
        body = _body_for(q, k, v)
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        stream = torch.cuda.current_stream(q.device).cuda_stream
        bind_context(q.device.index)    # the tensor maps need a context
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, S, T, Hq, Hkv, hd, *strides,
            hd ** -0.5, int(causal), int(window), float(softcap),
            _BODY_CODES[body], stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_fwd ({body} body) launch "
                               f"failed: error {err} (CUDA error, or "
                               f"100000 + the CUresult of a refused tensor "
                               f"map)")
        self._count(body)
        return out


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("the flash-attention kernel takes CUDA tensors only")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                         "takes float32 or bfloat16, the same for q, k and v")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: want [B,S,Hq,hd] and [B,T,Hkv,hd]")
    B, S, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if Hq % k.shape[2]:
        raise ValueError(f"{Hq} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride on head_dim")
        # the bf16 body moves 16-byte vectors
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"bf16 {name} needs a 16-byte aligned start and "
                             f"strides in multiples of 8, got {t.stride()}")


flash_kernel = FlashAttentionKernel()

"""Decode attention: the hand-written Hopper kernel and its plain version.

One query token a lane against that lane's keys and values in the serving
cache. ``decode_attention_ref`` is the plain PyTorch version, the models'
plain decode path (``models/attention.py::decode_attention``) and the CPU
path of ``ops.decode_attention``: it attends over the whole cache and masks
the positions after ``cache_index`` (and outside a sliding window).
``DecodeAttentionKernel`` builds ``csrc/decode_attention.cu`` for
``sm_90a`` at first use (``kernels/build.py``), loads it with ``ctypes`` and
launches it on PyTorch's current stream: it reads each lane's k and v in
place in the cache, up to the lane's position and no further, in split-KV
blocks whose partials a second kernel merges. ``decode_kernel.launches``
counts the launches, ``launches_by_body`` splits them by body (``"mma"``
for bfloat16, ``"fma"`` for float32).

Replaces no TPU kernel: the reference's decode attention is plain jnp. The
kernel was added for the port's decode step.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import KernelLibrary

NEG_INF = -2.3819763e38

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BODIES = {torch.float32: "fma", torch.bfloat16: "mma"}
FMA_SPLIT = 128            # positions a block of the float32 body
MMA_SPLITS = (512, 256, 128, 64)
BLOCKS_PER_SM = 4          # the bf16 body's split shrinks until it has these


def decode_attention_ref(q, ck, cv, cache_index, window: int = 0,
                         softcap: float = 0.0):
    """q: [B,1,Hq,hd]; ck, cv: [B,L,Hkv,hd]; cache_index: an int or a [B]
    tensor. Returns [B,1,Hq,hd] in q's dtype.

    Lane b attends to positions t <= cache_index[b] (and t > cache_index[b]
    - window with a sliding window); logits in float32, softcapped when
    ``softcap`` > 0; probabilities rounded to q's dtype before the sum over
    v. GQA: kv head = q head // (Hq / Hkv).
    """
    B, _, Hq, hd = q.shape
    L, Hkv = ck.shape[1], ck.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bkgh,btkh->bkgt", qg, ck).float() * hd ** -0.5
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    if torch.is_tensor(cache_index) and cache_index.dim() == 1:
        idx = cache_index[:, None, None, None]
    else:
        idx = cache_index
    pos = torch.arange(L, device=q.device)[None, None, None, :]
    valid = pos <= idx
    if window > 0:
        valid &= pos > idx - window
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    probs = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", probs, cv)
    return out.reshape(B, 1, Hq, hd)


def _split_for(dtype, B: int, Hkv: int, span: int, sms: int) -> int:
    """Positions a block takes: the float32 body's fixed ``FMA_SPLIT``; for
    bfloat16 the largest of ``MMA_SPLITS`` at which the longest span's
    blocks number ``BLOCKS_PER_SM`` an SM, else the smallest."""
    if dtype != torch.bfloat16:
        return FMA_SPLIT
    for split in MMA_SPLITS:
        if B * Hkv * -(-span // split) >= BLOCKS_PER_SM * sms:
            return split
    return MMA_SPLITS[-1]


class DecodeAttentionKernel(KernelLibrary):
    """ctypes binding of the CUDA kernel; ``launches`` counts its launches."""

    source = SOURCE
    name = "decode_attention"

    def _bind(self, lib) -> None:
        fn = lib.decode_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def __call__(self, q, ck, cv, cache_index, window: int = 0,
                 softcap: float = 0.0, split: Optional[int] = None):
        """Launch on CUDA tensors q [B,1,Hq,hd], ck/cv [B,L,Hkv,hd] (taken
        by their strides); ``cache_index`` an int or a [B] integer tensor
        on q's device, each in [0, L). ``split`` overrides the positions a
        block takes (a multiple of 16, at most 128 for float32)."""
        _check(q, ck, cv)
        lib = self.build()
        B, _, Hq, hd = q.shape
        L, Hkv = ck.shape[1], ck.shape[2]
        if torch.is_tensor(cache_index):
            if cache_index.device != q.device or cache_index.dim() > 1:
                raise ValueError(f"cache_index {tuple(cache_index.shape)} on "
                                 f"{cache_index.device}: want an int or a "
                                 f"[B] tensor on {q.device}")
            index = cache_index.to(torch.int64).expand(B).contiguous()
        else:
            index = torch.full((B,), int(cache_index), dtype=torch.int64,
                               device=q.device)
        out = torch.empty((B, 1, Hq, hd), dtype=q.dtype, device=q.device)
        if out.numel() == 0:
            return out
        span = min(L, window) if window > 0 else L
        if split is None:
            sms = torch.cuda.get_device_properties(
                q.device).multi_processor_count
            split = _split_for(q.dtype, B, Hkv, span, sms)
        ns = -(-span // split)
        part_o = torch.empty((B, Hq, ns, hd), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((B, Hq, ns, 2), dtype=torch.float32,
                              device=q.device)
        strides = [q.stride(0), q.stride(2), *ck.stride()[:3],
                   *cv.stride()[:3]]
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_fwd(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), index.data_ptr(),
            out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
            _DTYPE_CODES[q.dtype], B, L, Hq, Hkv, hd, *strides, hd ** -0.5,
            int(window), float(softcap), int(split), ns, stream)
        body = _BODIES[q.dtype]
        if err != 0:
            raise RuntimeError(f"decode_attention_fwd ({body} body) launch "
                               f"failed: CUDA error {err}")
        self._count(body)
        return out


def _check(q, ck, cv):
    if not (q.is_cuda and ck.is_cuda and cv.is_cuda):
        raise ValueError("the decode-attention kernel takes CUDA tensors only")
    if not (q.device == ck.device == cv.device):
        raise ValueError("q, ck and cv lie on different devices")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == ck.dtype == cv.dtype):
        raise ValueError(f"dtypes {q.dtype}, {ck.dtype}, {cv.dtype}: the "
                         "kernel takes float32 or bfloat16, the same for q "
                         "and the cache")
    if q.dim() != 4 or q.shape[1] != 1 or ck.dim() != 4 or \
            ck.shape != cv.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(ck.shape)}, "
                         f"{tuple(cv.shape)}: want [B,1,Hq,hd] and "
                         "[B,L,Hkv,hd]")
    B, _, Hq, hd = q.shape
    if ck.shape[0] != B or ck.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and the cache "
                         f"{tuple(ck.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if ck.shape[2] == 0 or Hq % ck.shape[2]:
        raise ValueError(f"{Hq} query heads are not a multiple of "
                         f"{ck.shape[2]} kv heads")
    for name, t, dims in (("q", q, (0, 2)), ("ck", ck, (0, 1, 2)),
                          ("cv", cv, (0, 1, 2))):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride on head_dim")
        # the bf16 body moves 16-byte vectors
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(t.stride(d) % 8 for d in dims)):
            raise ValueError(f"bf16 {name} needs a 16-byte aligned start and "
                             f"strides in multiples of 8, got {t.stride()}")


decode_kernel = DecodeAttentionKernel()

"""PyTorch port of the model stack and serving engine, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
from it. Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device for ``device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]

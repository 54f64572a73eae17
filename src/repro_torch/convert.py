"""Weight and cache conversion between the reference layout and the port.

The reference keeps parameters and caches as nested dicts of arrays
(``embed/tok_embed``, ``stack/pos00/mixer/wq``, ``pos00/k`` ...). The port
keeps the same keys with torch tensors at the leaves, so converted weights
compare one for one. Leaves cross as numpy arrays and keep their dtype:
the float32 leaves of a bfloat16 model (norm scales, the MoE ``router``,
Mamba's ``a_log``, ``dt_bias`` and ``ssm_d``, the sLSTM gate and recurrent
weights and biases, mLSTM's input/forget gate weights and skip scale,
recurrent states) stay float32. bfloat16 goes through float32,
which holds every bfloat16 value exactly, so the round trip
``to_numpy(to_torch(tree))`` returns the same values.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32))
        return t.to(device=device, dtype=torch.bfloat16)
    # a copy: arrays exported by other frameworks may be read-only
    return torch.from_numpy(np.array(a)).to(device)


def to_torch(tree: Mapping[str, Any], device="cuda") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors, same keys.

    On the card unless ``device="cpu"``, like the port's other entry
    points; asking for CUDA where there is none raises.
    """
    device = resolve_device(device)
    return {k: to_torch(v, device) if isinstance(v, Mapping)
            else _leaf_to_torch(v, device) for k, v in tree.items()}


def to_numpy(tree: Mapping[str, Any]) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays, same keys.

    bfloat16 leaves come back as float32 arrays holding the same values.
    """
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = to_numpy(v)
        else:
            t = v.detach().cpu()
            out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out

"""Shared helpers for the parity tests of the PyTorch port against the JAX
reference: the same config on both sides, reference weights converted to
the port, and seeded numpy inputs."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.models import build_model
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model as build_port_model

# logits tolerances: float32 runs agree to rounding; bf16 runs round at
# different points in the two frameworks (the reference tests' 2e-2)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def port_config(jax_cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jax_cfg))


def reference_view(port_cfg, ref_cfg) -> dict:
    """``dataclasses.asdict`` of a port config with the port's own fields
    left out (latent attention, DeepSeek-V3 routing: fields the reference
    lacks), each of which must hold its default, today's behaviour; the
    rest compares with the reference's ``asdict`` as it stands."""
    default = dataclasses.asdict(type(port_cfg)())

    def keep(port, ref, dflt):
        out = {}
        for key, value in port.items():
            if key not in ref:
                assert value == dflt[key], (key, value)
            elif isinstance(value, dict) and isinstance(ref[key], dict):
                out[key] = keep(value, ref[key], dflt[key])
            else:
                out[key] = value
        return out
    return keep(dataclasses.asdict(port_cfg), dataclasses.asdict(ref_cfg),
                default)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def models(arch: str, dtype: str = "bfloat16", seed: int = 0):
    """(jax_model, jax_params, port_model, port_params) for a smoke config,
    the port's weights converted from the reference's."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jm = build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    pm = build_port_model(port_config(cfg))
    pp = convert.to_torch(to_numpy(jp), device="cpu")
    return jm, jp, pm, pp


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)

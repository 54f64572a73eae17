"""Step functions on one device: train, prefill and decode.

The reference builds each step with its shardings for a mesh; the port runs
on one card, so each ``build_*`` function returns the step function alone. The sharding
rules (``rules_for``, ``cache_specs``, ``batch_specs``) wait for the port's
mesh layer.

- ``build_train_step``: ``(state, batch) -> (state, metrics)`` with state
  ``{"params", "opt"}`` updated in place (the reference donates it) and
  metrics ``{ce, aux, loss, grad_norm, lr}`` as 0-d tensors on the device.
  Gradients come from ``torch.autograd.grad`` over the parameter leaves
  (nothing accumulates in ``.grad``) and are freed before the step returns.
  The model runs its plain paths: the kernels are forward-only. The three
  parts of the step run inside the profiler ranges ``STEP_RANGES``
  (forward with the loss, backward, AdamW), so a profiled step splits its
  time by part.
- ``build_prefill_step`` and ``build_decode_step``: the serving steps;
  ``steps_per_dispatch=k`` runs k greedy decode steps in one call, the
  token fed back on the device with no host sync in between (the paper's
  aggregation at the step level).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule


STEP_RANGES = ("train_step.forward", "train_step.backward",
               "train_step.optimizer")


def make_optimizer(run: RunConfig) -> AdamW:
    """The trainer's AdamW: ``run``'s cosine schedule, decay and clip."""
    return AdamW(learning_rate=cosine_schedule(
        run.learning_rate, run.warmup_steps, run.total_steps),
        weight_decay=run.weight_decay, grad_clip=run.grad_clip)


def init_train_state(cfg: ModelConfig, run: Optional[RunConfig] = None,
                     device="cuda"):
    """{"params": random parameters from ``run.seed``, "opt": zero
    moments} on ``device``."""
    run = run or RunConfig(model=cfg)
    params = build_model(cfg).init(run.seed, device=device)
    return {"params": params, "opt": make_optimizer(run).init(params)}


def batch_to(batch, device) -> dict:
    """A batch dict of numpy arrays or tensors, as tensors on ``device``."""
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            .to(device, non_blocking=True) for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, shape: Optional[ShapeConfig] = None,
                     run: Optional[RunConfig] = None, device="cuda",
                     use_kernel: bool = False) -> Callable:
    """The train step of ``cfg`` on ``device``: loss and gradients of the
    whole batch, then AdamW in place. ``shape``, if given, is checked
    against every batch."""
    run = run or RunConfig(model=cfg)
    if use_kernel:
        raise ValueError("the train step runs the plain paths: the kernels "
                         "are forward-only (use_kernel=False)")
    dev = resolve_device(device)
    model = build_model(cfg)
    opt = make_optimizer(run)
    want = ({k: v[0] for k, v in model.input_specs(shape).items()}
            if shape is not None else None)

    def train_step(state, batch):
        batch = batch_to(batch, dev)
        if want is not None:
            got = {k: tuple(v.shape) for k, v in batch.items()}
            if got != want:
                raise ValueError(f"batch shapes {got}, want {want}")
        params = state["params"]
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with record_function(STEP_RANGES[0]):
            loss, metrics = model.loss(params, batch)
        with record_function(STEP_RANGES[1]):
            grads = torch.autograd.grad(loss, leaves)
        metrics = {"ce": metrics["ce"].detach(),
                   "aux": metrics["aux"].detach(), "loss": loss.detach()}
        del loss
        with record_function(STEP_RANGES[2]):
            params, opt_state, om = opt.update(
                tree_lib.unflatten(params, grads), state["opt"], params)
        del grads
        return {"params": params, "opt": opt_state}, dict(metrics, **om)

    return train_step


def pad_heads_for_tp(cfg: ModelConfig, model_size: int) -> ModelConfig:
    """Megatron-style query-head padding to a multiple of the tensor-
    parallel degree ``model_size`` (the reference reads it from its mesh's
    ``model`` axis), keeping GQA's grouping (kv heads divide the heads).
    Padded heads carry zero output projections, so logits are unchanged.
    Inference only: training would leak gradient into the padding. On one
    card ``model_size`` is 1 and nothing changes."""
    if cfg.n_heads % model_size == 0:
        return cfg
    padded = -(-cfg.n_heads // model_size) * model_size
    while padded % cfg.n_kv_heads != 0:
        padded += model_size
    return dataclasses.replace(cfg, n_heads=padded,
                               head_dim=cfg.resolved_head_dim)


def build_prefill_step(cfg: ModelConfig, use_kernel: bool = False,
                       device="cuda") -> Callable:
    """(params, batch) -> (last logits [B, padded_vocab], caches), the
    caches as long as the prompt."""
    model = build_model(cfg)
    dev = resolve_device(device)

    def prefill_step(params, batch):
        batch = batch_to(batch, dev)
        return model.prefill(params, batch["tokens"],
                             batch.get("frontend_embeds"),
                             use_kernel=use_kernel)

    return prefill_step


def build_decode_step(cfg: ModelConfig, steps_per_dispatch: int = 1
                      ) -> Callable:
    """(params, token [B,1], caches, cache_index) -> (logits [B,
    padded_vocab], caches), caches written in place. With
    ``steps_per_dispatch`` k > 1, k greedy steps at cache_index,
    cache_index + 1, ...: each step's argmax is the next step's token, on
    the device; the logits are the last step's."""
    model = build_model(cfg)

    def decode_step(params, token, caches, cache_index):
        logits, caches = model.decode_step(params, token, caches, cache_index)
        for i in range(1, steps_per_dispatch):
            token = logits.argmax(dim=-1, keepdim=True)
            logits, caches = model.decode_step(params, token, caches,
                                               cache_index + i)
        return logits, caches

    return decode_step

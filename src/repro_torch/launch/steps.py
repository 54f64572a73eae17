"""Step functions: train, prefill and decode, meshless or on a mesh.

Each ``build_*`` function returns the step function. With ``mesh=None``
(the default) the step runs on one device with plain tensors. With a
``DeviceMesh`` (``launch/mesh.py``) it runs under ``use_rules(mesh,
rules)`` on DTensors laid out as the reference's shardings: parameters by
``param_specs``, AdamW's m and v by ``zero1_specs``, batches by
``batch_specs``, caches by ``cache_specs`` (plain inputs are distributed on
entry; each rank keeps its shard). Tensors that the model makes itself
(positions, masks, rope tables) are plain and count as replicated
(``implicit_replication``). ``build_step`` returns a ``BuiltStep``: the
step with its specs and meta stand-ins for its inputs, for the dry run.

- ``build_train_step``: ``(state, batch) -> (state, metrics)`` with state
  ``{"params", "opt"}`` updated in place (the reference donates it) and
  metrics ``{ce, aux, loss, grad_norm, lr}`` as 0-d plain tensors.
  Gradients come from ``torch.autograd.grad`` over the parameter leaves
  (nothing accumulates in ``.grad``) and are freed before the step returns.
  The model runs its plain paths: the kernels are forward-only. The three
  parts of the step run inside the spans ``STEP_RANGES`` (forward with the
  loss, backward, AdamW; ``obs.spans``), so a profiled step splits its
  time by part.
- ``build_prefill_step`` and ``build_decode_step``: the serving steps;
  ``steps_per_dispatch=k`` runs k greedy decode steps in one call, the
  token fed back on the device with no host sync in between (the paper's
  aggregation at the step level).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import build_model
from repro_torch.obs.spans import span
from repro_torch.optim.adamw import AdamW, OptState, cosine_schedule


STEP_RANGES = ("train_step.forward", "train_step.backward",
               "train_step.optimizer")

# ---------------------------------------------------------------------------
# Cache logical axes (path + ndim based)
# ---------------------------------------------------------------------------

_CACHE_RULES = (
    # attention KV cache [groups, B, L, kv_heads, head_dim]
    (r"/(k|v)$", 5, (None, "batch", "seq_kv", "kv_heads", "head_dim")),
    # mamba conv state [groups, B, K-1, din] / h [groups, B, din, N]
    (r"/conv$", 4, (None, "batch", None, "ssm_inner")),
    (r"/h$", 4, (None, "batch", "ssm_inner", None)),
    # mLSTM: C [g,B,H,dh,dh], n [g,B,H,dh], m [g,B,H]
    (r"/C$", 5, (None, "batch", "heads", None, None)),
    (r"/n$", 4, (None, "batch", "heads", None)),
    (r"/m$", 3, (None, "batch", "heads")),
    # sLSTM: c/n/m/h [g, B, d]
    (r"/(c|n|m|h)$", 3, (None, "batch", None)),
)


# the port's own cache leaves, which the reference lacks: latent attention's
# ckv [groups, B, L, kv_lora_rank] and kpe [groups, B, L, qk_rope_head_dim]
_PORT_CACHE_RULES = (
    (r"/(ckv|kpe)$", 4, (None, "batch", "seq_kv", None)),
)


def cache_logical_axes(path: str, ndim: int):
    for pat, nd, axes in _CACHE_RULES + _PORT_CACHE_RULES:
        if nd == ndim and re.search(pat, path):
            return axes
    return (None,) * ndim


def cache_specs(caches, rules: shd.ShardingRules, mesh):
    sizes = axis_sizes(mesh)
    return shd._map_specs(
        lambda p, x: rules.spec(cache_logical_axes(p, len(shd._shape(x))),
                                shape=shd._shape(x), axis_sizes=sizes),
        caches)


# ---------------------------------------------------------------------------
# Rules per shape
# ---------------------------------------------------------------------------

def rules_for(mesh, cfg: ModelConfig, shape: Optional[ShapeConfig] = None,
              overrides: Optional[Dict[str, Any]] = None) -> shd.ShardingRules:
    rules = dict(shd.default_rules(mesh, cfg).rules)
    names = set(axis_sizes(mesh))
    if shape is not None and shape.kind == "decode":
        if shape.global_batch == 1:
            # long-context single-stream decode: shard the KV sequence over
            # every axis (flash-decode); batch axes are useless at B=1.
            rules["seq_kv"] = tuple(a for a in ("pod", "data", "model")
                                    if a in names)
        else:
            rules["seq_kv"] = "model"
    if overrides:
        rules.update(overrides)
    return shd.ShardingRules(rules)


def batch_specs(specs, mesh, rules: shd.ShardingRules):
    """Specs for a batch dict: dim0 = batch, dim1 = seq for the [B, S]
    token/label/mask arrays (seq shards under SP rules). ``specs`` holds
    tensors, arrays or (shape, dtype) pairs."""
    sizes = axis_sizes(mesh)

    def spec(x):
        shape = shd._shape(x)
        names = (("batch", "seq") if len(shape) == 2
                 else ("batch",) + (None,) * (len(shape) - 1))
        return rules.spec(names, shape=shape, axis_sizes=sizes)

    return {k: spec(v) for k, v in specs.items()}


def token_spec(rules: shd.ShardingRules, mesh, batch: int):
    """Spec of a decode step's [B, 1] token."""
    return rules.spec(("batch", None), shape=(batch, 1),
                      axis_sizes=axis_sizes(mesh))


def shard_train_state(state, mesh, rules: shd.ShardingRules):
    """A train state on ``mesh``: parameters by ``param_specs``, m and v by
    ``zero1_specs``; the step counter stays a plain (replicated) scalar."""
    params, opt = state["params"], state["opt"]
    return {"params": shd.shard_tree(
                params, shd.param_specs(params, rules, mesh), mesh),
            "opt": OptState(step=opt.step, m=shd.shard_tree(
                opt.m, shd.zero1_specs(opt.m, rules, mesh), mesh),
                v=shd.shard_tree(opt.v, shd.zero1_specs(opt.v, rules, mesh),
                                 mesh))}


def shard_batch(batch, mesh, rules: shd.ShardingRules):
    specs = batch_specs(batch, mesh, rules)
    return {k: shd.distribute(v, mesh, specs[k]) for k, v in batch.items()}


def shard_caches(caches, mesh, rules: shd.ShardingRules):
    return shd.shard_tree(caches, cache_specs(caches, rules, mesh), mesh)


@contextlib.contextmanager
def on_mesh(mesh, rules):
    """The context a mesh step runs in: the rules, and plain tensors taken
    as replicated where they meet DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    with shd.use_rules(mesh, rules), implicit_replication(), \
            shd.dtensor_handlers():
        yield


def _plain(t):
    """A DTensor's full value as a plain tensor, detached (on a mesh of
    one device, its local tensor itself)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor().detach() if isinstance(t, DTensor) else t


def _mesh_device(mesh) -> torch.device:
    return torch.device("cpu" if mesh.device_type == "cpu"
                        else f"{mesh.device_type}:{torch.cuda.current_device()}")


def _step_input_device(mesh, device):
    return _mesh_device(mesh) if mesh is not None else resolve_device(device)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

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
    """A batch dict of numpy arrays or tensors, as tensors on ``device``
    (DTensors stay as they are)."""
    from torch.distributed.tensor import DTensor

    return {k: v if isinstance(v, DTensor) else
            (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            .to(device, non_blocking=True) for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, shape: Optional[ShapeConfig] = None,
                     run: Optional[RunConfig] = None, device="cuda",
                     use_kernel: bool = False, mesh=None,
                     rules: Optional[shd.ShardingRules] = None) -> Callable:
    """The train step of ``cfg`` on ``device`` (or on ``mesh``): loss and
    gradients of the whole batch, then AdamW in place. ``shape``, if
    given, is checked against every batch."""
    run = run or RunConfig(model=cfg)
    if use_kernel:
        raise ValueError("the train step runs the plain paths: the kernels "
                         "are forward-only (use_kernel=False)")
    dev = _step_input_device(mesh, device)
    model = build_model(cfg)
    opt = make_optimizer(run)
    want = ({k: v[0] for k, v in model.input_specs(shape).items()}
            if shape is not None else None)
    if mesh is not None:
        rules = rules or rules_for(mesh, cfg, shape)

    def step(state, batch):
        if want is not None:
            got = {k: tuple(v.shape) for k, v in batch.items()}
            if got != want:
                raise ValueError(f"batch shapes {got}, want {want}")
        params = state["params"]
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with span(STEP_RANGES[0]):
            loss, metrics = model.loss(params, batch)
        with span(STEP_RANGES[1]), (
                shd.backward_views(mesh) if mesh is not None
                else contextlib.nullcontext()):
            grads = torch.autograd.grad(loss, leaves)
        metrics = {"ce": metrics["ce"].detach(),
                   "aux": metrics["aux"].detach(), "loss": loss.detach()}
        del loss
        with span(STEP_RANGES[2]):
            params, opt_state, om = opt.update(
                tree_lib.unflatten(params, grads), state["opt"], params)
        del grads
        return {"params": params, "opt": opt_state}, dict(metrics, **om)

    if mesh is None:
        return lambda state, batch: step(state, batch_to(batch, dev))

    def mesh_step(state, batch):
        batch = batch_to(batch, dev)
        with on_mesh(mesh, rules):
            state = shard_train_state(state, mesh, rules)
            state, metrics = step(state, shard_batch(batch, mesh, rules))
        return state, {k: _plain(v) for k, v in metrics.items()}

    return mesh_step


def pad_heads_for_tp(cfg: ModelConfig, model_size) -> ModelConfig:
    """Megatron-style query-head padding to a multiple of the tensor-
    parallel degree: ``model_size`` is an int or a mesh, whose ``model``
    axis gives it (as the reference reads it). GQA's grouping is kept (kv
    heads divide the heads). Padded heads carry zero output projections,
    so logits are unchanged. Inference only: training would leak gradient
    into the padding. On one card ``model_size`` is 1 and nothing
    changes."""
    if not isinstance(model_size, int):
        model_size = axis_sizes(model_size).get("model", 1)
    if cfg.n_heads % model_size == 0:
        return cfg
    padded = -(-cfg.n_heads // model_size) * model_size
    while padded % cfg.n_kv_heads != 0:
        padded += model_size
    return dataclasses.replace(cfg, n_heads=padded,
                               head_dim=cfg.resolved_head_dim)


def build_prefill_step(cfg: ModelConfig, use_kernel: bool = False,
                       device="cuda", mesh=None,
                       rules: Optional[shd.ShardingRules] = None,
                       shape: Optional[ShapeConfig] = None) -> Callable:
    """(params, batch) -> (last logits [B, padded_vocab], caches), the
    caches as long as the prompt. On a mesh, ``cfg``'s heads are padded to
    the model axis (the parameters must be the padded config's) and the
    caches are laid out by ``cache_specs``."""
    dev = _step_input_device(mesh, device)
    if mesh is None:
        model = build_model(cfg)

        def prefill_step(params, batch):
            batch = batch_to(batch, dev)
            return model.prefill(params, batch["tokens"],
                                 batch.get("frontend_embeds"),
                                 use_kernel=use_kernel)

        return prefill_step

    cfg = pad_heads_for_tp(cfg, mesh)
    model = build_model(cfg)
    rules = rules or rules_for(mesh, cfg, shape)

    def mesh_prefill_step(params, batch):
        batch = batch_to(batch, dev)
        with on_mesh(mesh, rules):
            params = shd.param_shardings(params, mesh, rules)
            batch = shard_batch(batch, mesh, rules)
            tokens = batch["tokens"]
            B, S = tokens.shape
            caches = shard_caches(model.init_caches(B, S, tokens.device),
                                  mesh, rules)
            logits, caches = model.forward(
                params, tokens, batch.get("frontend_embeds"), caches=caches,
                cache_index=0, use_kernel=use_kernel)
            return logits[:, -1], caches

    return mesh_prefill_step


def build_decode_step(cfg: ModelConfig, steps_per_dispatch: int = 1,
                      mesh=None, rules: Optional[shd.ShardingRules] = None,
                      shape: Optional[ShapeConfig] = None) -> Callable:
    """(params, token [B,1], caches, cache_index) -> (logits [B,
    padded_vocab], caches), caches written in place. With
    ``steps_per_dispatch`` k > 1, k greedy steps at cache_index,
    cache_index + 1, ...: each step's argmax is the next step's token, on
    the device; the logits are the last step's. On a mesh, as
    ``build_prefill_step``; pass the caches the mesh prefill returned, so
    the writes land in them."""
    if mesh is not None:
        cfg = pad_heads_for_tp(cfg, mesh)
    model = build_model(cfg)

    def decode_step(params, token, caches, cache_index):
        logits, caches = model.decode_step(params, token, caches, cache_index)
        for i in range(1, steps_per_dispatch):
            token = logits.argmax(dim=-1, keepdim=True)
            logits, caches = model.decode_step(params, token, caches,
                                               cache_index + i)
        return logits, caches

    if mesh is None:
        return decode_step
    rules = rules or rules_for(mesh, cfg, shape)

    def mesh_decode_step(params, token, caches, cache_index):
        with on_mesh(mesh, rules):
            params = shd.param_shardings(params, mesh, rules)
            token = shd.distribute(token, mesh,
                                   token_spec(rules, mesh, token.shape[0]))
            caches = shard_caches(caches, mesh, rules)
            return decode_step(params, token, caches, cache_index)

    return mesh_decode_step


# ---------------------------------------------------------------------------
# Built steps for the dry run
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, Any]:
    """Tensors shaped like every input of the step that ``shape``
    exercises, on ``device`` (meta: no memory): a train or prefill batch,
    or a decode step's token, caches and cache index."""
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": torch.zeros((B, 1), dtype=torch.int32,
                                     device=device),
                "caches": model.init_caches(B, S, device),
                "cache_index": S - 1}
    specs = model.input_specs(dataclasses.replace(shape, kind="train"))
    if shape.kind == "prefill":
        specs.pop("labels")
        specs.pop("loss_mask", None)
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in specs.items()}


@dataclass
class BuiltStep:
    """A step with its specs: ``fn`` takes ``args`` (DTensors laid out by
    ``in_specs``); ``input_specs`` are the same inputs as plain tensors."""

    fn: Callable
    in_specs: Any
    input_specs: Any
    mesh: Any
    rules: shd.ShardingRules

    def args(self):
        """``input_specs`` distributed by ``in_specs``."""
        with on_mesh(self.mesh, self.rules):
            return tuple(
                x if not (torch.is_tensor(x) or isinstance(x, dict))
                else shd.shard_tree(x, s, self.mesh)
                for x, s in zip(self.input_specs, self.in_specs))


def build_step(cfg: ModelConfig, mesh, shape: ShapeConfig, device="meta",
               run: Optional[RunConfig] = None,
               rules: Optional[shd.ShardingRules] = None,
               **kw) -> BuiltStep:
    """The step of ``shape``'s kind on ``mesh``, with its parameter,
    optimizer, batch and cache specs and inputs on ``device``."""
    if shape.kind != "train":
        cfg = pad_heads_for_tp(cfg, mesh)
    rules = rules or rules_for(mesh, cfg, shape)
    model = build_model(cfg)
    params = model.init(0, device=device)
    pspecs = shd.param_specs(params, rules, mesh)
    inputs = input_specs(cfg, shape, device)
    if shape.kind == "train":
        run = run or RunConfig(model=cfg)
        state = {"params": params, "opt": make_optimizer(run).init(params)}
        ospecs = {"params": pspecs, "opt": OptState(
            step=None, m=shd.zero1_specs(params, rules, mesh),
            v=shd.zero1_specs(params, rules, mesh))}
        fn = build_train_step(cfg, run=run, mesh=mesh, rules=rules, **kw)
        return BuiltStep(fn, (ospecs, batch_specs(inputs, mesh, rules)),
                         (state, inputs), mesh, rules)
    if shape.kind == "prefill":
        fn = build_prefill_step(cfg, mesh=mesh, rules=rules, **kw)
        return BuiltStep(fn, (pspecs, batch_specs(inputs, mesh, rules)),
                         (params, inputs), mesh, rules)
    if shape.kind == "decode":
        fn = build_decode_step(cfg, mesh=mesh, rules=rules, **kw)
        return BuiltStep(
            fn, (pspecs, token_spec(rules, mesh, shape.global_batch),
                 cache_specs(inputs["caches"], rules, mesh), None),
            (params, inputs["token"], inputs["caches"],
             inputs["cache_index"]), mesh, rules)
    raise ValueError(shape.kind)


"""Training entry point: config-driven and restartable, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4_mini_3_8b \\
      --steps 100 --batch 8 --seq 512 --ckpt-dir /path/to/run1
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4_mini_3_8b \\
      --smoke --device cpu --steps 20 --seq 64

The published config by default (on the card), ``--smoke`` for the reduced
same-family one; the CPU takes only ``--smoke``. The learning rate follows
``RunConfig``'s cosine schedule (warmup 100 steps). Restart is automatic:
if the checkpoint directory holds a committed step, training resumes from
it, bit for bit, since the data stream is seeded per step.

``--mesh`` (default ``none``: plain tensors on one device) runs the step
on a ``DeviceMesh`` with the reference's shardings: ``host`` is this
process's (world size, 1) mesh, one device without torchrun; ``single``
and ``multi`` are the (16, 16) and (2, 16, 16) production meshes, which
need torchrun at 256 or 512 ranks and raise otherwise (the mesh is never
shrunk). On one card the mesh is the same arithmetic as ``none`` with
DTensor's host cost on every operation, so ``none`` stays the default.

On a mesh every rank builds the whole train state from the seed and keeps
its shards, so a model trains on a mesh of several devices only if its
whole state (parameters, m and v) fits one device; a larger one raises
before anything is built. Every rank takes part in gathering the state
for a checkpoint, and rank 0 alone writes it; every rank waits for the
last one to be written and restores from it.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import RunConfig, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticTokens, TokenPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import (_plain, build_train_step,
                                      init_train_state, rules_for,
                                      shard_train_state)
from repro_torch.models.model import FRONTEND_TOKENS
from repro_torch.tree import leaves


def make_train_mesh(kind: str, device="cuda"):
    """None for "none", else the ``--mesh`` kind's DeviceMesh."""
    if kind == "none":
        return None
    if kind == "host":
        return mesh_lib.make_host_mesh(str(device))
    return mesh_lib.make_production_mesh(multi_pod=(kind == "multi"),
                                         device=str(device))


def train(cfg: ModelConfig, run: RunConfig, steps: int, device="cuda",
          ckpt_dir: str = "", ckpt_every: int = 50, log_every: int = 10,
          on_step: Optional[Callable] = None, state=None, mesh=None):
    """Train ``cfg`` to step ``steps`` on batches of ``run``'s shape.

    Starts from ``state`` (default: fresh from ``run.seed``), or from the
    newest committed step in ``ckpt_dir``. After each step, whose loss is
    read back to the host, ``on_step(step, metrics, ms)`` is called with
    the step's host time. With ``mesh``, the state lives on it as
    DTensors (checkpoints hold the full tensors). Returns (state,
    losses)."""
    dev = resolve_device(device)
    rules = rules_for(mesh, cfg) if mesh is not None else None
    step_fn = build_train_step(cfg, run=run, device=dev, mesh=mesh,
                               rules=rules)
    nf = FRONTEND_TOKENS.get(cfg.frontend, 0)
    source = SyntheticTokens(cfg.vocab_size, run.seq_len, run.global_batch,
                             seed=run.seed,
                             frontend_dim=cfg.frontend_dim if nf else 0,
                             frontend_tokens=nf)
    if state is None:
        if (mesh is not None and dev.type == "cuda"
                and math.prod(mesh.shape) > 1):
            check_whole_state_fits(
                cfg, run, torch.cuda.get_device_properties(dev).total_memory)
        state = init_train_state(cfg, run, dev)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    writer = not dist.is_initialized() or dist.get_rank() == 0
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        state, extra = mgr.restore(_full(state))
        start_step = int(extra.get("step", mgr.latest_step()))
        print(f"[restore] resumed from step {start_step}", flush=True)
    if mesh is not None:
        state = shard_train_state(state, mesh, rules)

    pipe = TokenPipeline(source, device=dev, start_step=start_step,
                         mesh=mesh)
    losses = []
    t_start = time.perf_counter()
    try:
        for _ in range(start_step, steps):
            step, batch = next(pipe)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            ms = (time.perf_counter() - t0) * 1e3
            if on_step is not None:
                on_step(step, metrics, ms)
            if (step + 1) % log_every == 0:
                rate = (step + 1 - start_step) / (time.perf_counter()
                                                  - t_start)
                print(f"step {step + 1:5d}  loss {losses[-1]:.4f}  "
                      f"ce {float(metrics['ce']):.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"lr {float(metrics['lr']):.2e}  {ms:.1f} ms  "
                      f"{rate * run.seq_len * run.global_batch:.0f} tok/s",
                      flush=True)
            if mgr is not None and (step + 1) % ckpt_every == 0:
                full = _full(state)       # a collective on a mesh
                if writer:
                    mgr.save(step + 1, full, extra={"step": step + 1})
    finally:
        pipe.close()
    if mgr is not None:
        full = _full(state)
        if writer:
            mgr.save(steps, full, extra={"step": steps})
            mgr.wait()
        if mesh is not None:
            dist.barrier()      # no rank reads the checkpoint before it is whole
    return state, losses


def check_whole_state_fits(cfg: ModelConfig, run: RunConfig,
                           capacity: int) -> None:
    """Raise if ``cfg``'s whole train state (as ``init_train_state`` makes
    it, counted on meta tensors) takes more than ``capacity`` bytes."""
    need = sum(t.numel() * t.element_size()
               for t in leaves(init_train_state(cfg, run, "meta")))
    if need > capacity:
        raise RuntimeError(
            f"every rank builds the whole train state ({need / 1e9:.1f} GB) "
            f"before keeping its shards, more than one device's "
            f"{capacity / 1e9:.1f} GB; building the shards alone is not "
            "in the port yet")


def _full(state):
    """A train state with every DTensor as its full tensor."""
    from repro_torch.tree import map_tree

    return map_tree(_plain, state)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4_mini_3_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "single", "multi"])
    args = ap.parse_args(argv)

    if not args.smoke and resolve_device(args.device).type == "cpu":
        ap.error("the published configs train on the card; pass --smoke "
                 "to train the reduced config on the CPU")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = RunConfig(model=cfg, seq_len=args.seq, global_batch=args.batch,
                    learning_rate=args.lr, total_steps=args.steps)
    mesh = make_train_mesh(args.mesh, resolve_device(args.device))
    try:
        _, losses = train(cfg, run, args.steps, device=args.device,
                          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                          log_every=args.log_every, mesh=mesh)
    finally:
        if mesh is not None:
            mesh_lib.destroy_group()
    if len(losses) > 20:
        first = float(np.mean(losses[:10]))
        last = float(np.mean(losses[-10:]))
        print(f"[done] loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()

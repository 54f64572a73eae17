"""End-to-end training example: a small LM trained for a few hundred steps
with checkpoints and a failure injected mid-run.

The model is the reduced Phi-4-mini config, so 200 steps take seconds.
Shows:
  * data pipeline -> train step -> AdamW (the loss falls);
  * synchronous checkpoints and an exact restart;
  * failure recovery by the supervisor (restore, re-mesh plan, resume).

  PYTHONPATH=src python -m repro_torch.examples.train_lm               # card
  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_lm --mesh host

``--mesh host`` runs the step on this process's one-device mesh, as the
reference's example does (``make_host_mesh``); the supervisor keeps and
checkpoints the state as plain tensors between steps.

Four slices; slice 1 fails at step 120, and the run resumes from the
checkpoint of step 100. Checkpoints go to a temporary directory, removed
at the end. Raises unless the loss fell and exactly one restore happened.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     TrainSupervisor)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import (_plain, build_train_step,
                                      init_train_state)
from repro_torch.tree import map_tree

STEPS = 200
BATCH, SEQ = 8, 64
FAILURES = {120: 1}   # slice 1 dies at step 120


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="none", choices=["none", "host"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = mesh_lib.make_host_mesh(dev.type) if args.mesh == "host" else None
    try:
        return _run(dev, mesh)
    finally:
        if mesh is not None:
            mesh_lib.destroy_group()


def _run(dev, mesh) -> dict:

    cfg = get_smoke_config("phi4_mini_3_8b")
    # the reference's schedule: cosine_schedule(1e-3, 20, STEPS)
    run = RunConfig(model=cfg, seq_len=SEQ, global_batch=BATCH,
                    learning_rate=1e-3, warmup_steps=20, total_steps=STEPS)
    step_fn = build_train_step(cfg, run=run, device=dev, mesh=mesh)
    source = SyntheticTokens(cfg.vocab_size, SEQ, BATCH)
    state = init_train_state(cfg, run, dev)
    losses = []

    def train_fn(state, step):
        state, metrics = step_fn(state, source.batch_at(step))
        state = map_tree(_plain, state)
        losses.append(float(metrics["loss"]))
        if (step + 1) % 25 == 0:
            print(f"  step {step + 1:4d}  loss {losses[-1]:.4f}", flush=True)
        return state

    failures = dict(FAILURES)
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        mon = HeartbeatMonitor(n_slices=4)
        for i in range(4):
            mon.beat(i)
        sup = TrainSupervisor(CheckpointManager(tmp, async_write=False),
                              mon, global_batch=BATCH, checkpoint_every=50)
        state, report = sup.run(
            state, train_fn, 0, STEPS,
            failure_injector=lambda s: failures.pop(s, None))
    dt = time.time() - t0
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"done in {dt:.1f}s: loss {first:.3f} -> {last:.3f}; "
          f"failures={report.failures} restores={report.restores} "
          f"remesh={report.remeshes}")
    if not last < first:
        raise AssertionError("training must reduce loss")
    if report.restores != 1:
        raise AssertionError("failure must trigger a checkpoint restore")
    print("OK: end-to-end training with failure recovery")
    return {"losses": losses, "first": first, "last": last, "seconds": dt,
            "report": report, "state": state}


if __name__ == "__main__":
    main()

"""Training driver: the step ``repro_torch.launch.steps.build_train_step``
returns, fed the benchmark's batches, the loss read back every step as
``launch/train.py::train`` does.

Set-up builds one train state (the benchmark's weights, the program's
AdamW state) and one step function, and drives them through the first
``check_steps`` steps on the seed's batches: the steps the reference
follows. From them it keeps the loss of each, the norm of each leaf's
first gradient as the optimizer took it (read from m after step 1: m =
(1 − b1) g) and the norm of each leaf's change over those steps. The same
state and step then run the window, on the batches that follow, until the
first step boundary after ``seconds``.

Afterwards the check: the reference follows the same steps from the same
weights and batches; the three numbers compared are the largest relative
gaps of the losses, of the first gradients' norms and of the changes'
norms (a leaf's gap over the larger of its reference norm and the median
leaf's). Leaves whose reference gradient is under a thousandth of the
median leaf's are left out of the norms.
"""
from __future__ import annotations

import contextlib
import gc
import time
from types import SimpleNamespace

import torch

from perfbench import traffic
from perfbench.trace import profiled


def run(ctx) -> SimpleNamespace:
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.steps import build_train_step, make_optimizer
    from repro_torch.tree import leaves

    mix, dev = ctx.mix, ctx.device
    cuda = torch.device(dev).type == "cuda"
    vocab = ctx.cfg["vocab_size"]
    run_cfg = program_run_config(ctx, RunConfig)
    marks = {"start": time.perf_counter() - ctx.t_start}
    params = ctx.ref.make_params(ctx.cfg, ctx.seed, dev)
    state = {"params": params, "opt": make_optimizer(run_cfg).init(params)}
    step = build_train_step(ctx.model_cfg, run=run_cfg, device=dev)
    paths = list(ctx.ref.flatten(params))   # the program's leaf order
    order = sorted(range(len(paths)), key=lambda i: _tree_key(paths[i]))

    def batch(i):
        return traffic.train_batch(mix, ctx.seed, i, vocab, dev)

    losses, grad_norm = [], {}
    n_check = mix["check_steps"]
    for i in range(1, n_check + 1):
        state, metrics = step(state, batch(i))
        losses.append(float(metrics["loss"]))
        if i == 1:
            m = leaves(state["opt"].m)
            for j, k in enumerate(order):
                grad_norm[paths[k]] = float(
                    (m[j] / (1 - mix["adamw"]["b1"])).norm())
    change_norm = {}
    with torch.no_grad():
        flat = ctx.ref.flatten(state["params"])
        for path in paths:
            p0 = ctx.ref.make_leaf(ctx.cfg, ctx.seed, path, dev)
            change_norm[path] = float((flat[path].float() - p0.float()).norm())
            del p0
    if cuda:
        torch.cuda.synchronize()

    seconds = min(ctx.seconds, mix.get("trace_seconds", ctx.seconds)) \
        if ctx.trace else ctx.seconds
    out = {}
    step_times = []
    bad = 0
    i = n_check
    marks["checks"] = time.perf_counter() - ctx.t_start
    with (profiled(ctx.trace_path, out, cuda) if ctx.trace
          else contextlib.nullcontext()):
        t0 = time.perf_counter()       # after the profiler has started
        setup_s = t0 - ctx.t_start
        while True:
            i += 1
            a = time.perf_counter()
            state, metrics = step(state, batch(i))
            loss = float(metrics["loss"])
            t = time.perf_counter()
            step_times.append((a, t))
            bad += not (loss == loss and abs(loss) != float("inf"))
            if t - t0 >= seconds:
                break
    t1 = t
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del state, metrics, step, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    program = {"loss": losses, "grad_norm": grad_norm,
               "change_norm": change_norm}
    reference = ctx.ref.adamw_steps(
        ctx.cfg, ctx.seed, mix, (batch(j) for j in range(1, n_check + 1)),
        dev, block_rows=mix["reference_block_rows"])
    steps = len(step_times)
    return SimpleNamespace(
        kind="train", cfg=ctx.cfg, mix=mix, setup_s=setup_s,
        window=(t0, t1), steps=step_times,
        tokens=steps * mix["batch"] * mix["seq"], memory_peak=memory_peak,
        attempted=steps, failed=bad, counters={},
        checks=compare(program, reference),
        check_notes={"loss": losses, "reference_loss": reference["loss"],
                     "setup_marks_s": marks},
        trace=out.get("trace"))


def program_run_config(ctx, RunConfig):
    mix = ctx.mix
    return RunConfig(model=ctx.model_cfg, seq_len=mix["seq"],
                     global_batch=mix["batch"],
                     learning_rate=mix["learning_rate"],
                     warmup_steps=mix["warmup_steps"],
                     total_steps=mix["total_steps"],
                     weight_decay=mix["weight_decay"],
                     grad_clip=mix["grad_clip"], seed=0)


def _tree_key(path: str):
    """A leaf's place in the program's flattening (dict keys sorted at
    every level)."""
    return path.split("/")


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return (xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])) \
        if n else 0.0


def compare(program: dict, reference: dict, floor: float = 1e-3) -> dict:
    """The three numbers: loss_gap (largest |ΔL| / |L_ref| over the
    steps), grad_gap and change_gap (largest |‖x_prog‖ − ‖x_ref‖| over
    max(‖x_ref‖, median leaf's ‖x_ref‖), over the leaves whose reference
    gradient is at least ``floor`` of the median leaf's)."""
    loss_gap = max((abs(p - r) / abs(r) if r else float("inf"))
                   for p, r in zip(program["loss"], reference["loss"]))
    ref_g = reference["grad_norm"]
    med_g = _median(list(ref_g.values()))
    kept = [k for k, v in ref_g.items() if v >= floor * med_g]
    out = {"loss_gap": loss_gap}
    for name, key in (("grad_gap", "grad_norm"),
                      ("change_gap", "change_norm")):
        ref = reference[key]
        med = _median([ref[k] for k in kept])
        gaps = [abs(program[key].get(k, 0.0) - ref[k])
                / max(ref[k], med) if max(ref[k], med) > 0 else float("inf")
                for k in kept]
        out[name] = max(gaps) if gaps else float("inf")
    if len(program["loss"]) != len(reference["loss"]):
        out["loss_gap"] = float("inf")
    return out

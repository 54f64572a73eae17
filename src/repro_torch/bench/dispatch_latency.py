"""The paper's latency model applied to real PyTorch dispatch.

Measures the framework's own scheduler latency t_s (the cost of one
dispatch of a near-zero-work task) and shows that the paper's utilisation
law holds at microseconds: many tiny dispatches, each waited for, collapse
utilisation; queueing them back to back (multilevel scheduling: many
tasks, one wait) restores it.

  PYTHONPATH=src python -m repro_torch.bench.dispatch_latency [--device cpu]

The task is the reference's: ``x = tanh(x @ x)`` on a 128 x 128 float32
matrix, repeated ``flops_scale`` times. A jitted JAX call is one dispatch
whatever it holds; eager PyTorch launches one kernel per operation, two
per repeat, so each row also reports the kernels one task launched on the
card (counted by torch.profiler). The near-zero-work task launches
exactly one kernel: ``torch.neg`` over the same matrix (an identity
launches none). Times are on the host clock around work that ends in a
synchronise. Runs on the card unless ``--device cpu`` is given; without
a card it fails. Prints CSV and writes no file.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core.executor import TorchDispatchExecutor
from repro_torch.core.job import Task
from repro_torch.core.latency_model import (ModelFit, fit_power_law,
                                            utilization_approx)
from repro_torch.obs.spans import span

D = 128
SCALES = (1, 4, 16, 64)
TASK_SPAN = "dispatch_latency.task"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _work_fn(flops_scale: int, dev: torch.device):
    """A task whose work scales with ``flops_scale``; 0 is the near-zero
    work task (one ``neg`` kernel)."""
    def step(x):
        if flops_scale == 0:
            return torch.neg(x)
        for _ in range(flops_scale):
            x = torch.tanh(x @ x)
        return x

    x = torch.eye(D, dtype=torch.float32, device=dev) * 0.1
    step(x)
    _sync(dev)   # warm: the BLAS handle, the allocator's blocks
    return step, x


def launches_per_task(step, x, dev: torch.device, warm: int = 64,
                      ranges: int = 3, sessions: int = 3):
    """Kernels one call of ``step`` launches on the card (None on the
    CPU, which launches none), by torch.profiler: the kernels whose launch
    call lies inside the call's range. A profile can lose device events,
    never add them: one lost its first 16, another all of one call's. So
    each of ``sessions`` sessions first launches ``warm`` near-zero-work
    kernels, then profiles the call in ``ranges`` spans ``TASK_SPAN`` of
    its own, and the count is the largest that any span saw."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = 0
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(warm):
                torch.neg(x)
            _sync(dev)
            for _ in range(ranges):
                with span(TASK_SPAN):
                    step(x)
                _sync(dev)
        events = prof.events()
        tasks = [e.time_range for e in events if e.name == TASK_SPAN
                 and e.device_type == DeviceType.CPU]
        for task in tasks:
            launched = {e.id for e in events
                        if e.device_type == DeviceType.CPU
                        and e.name.startswith("cu")
                        and task.start <= e.time_range.start <= task.end}
            best = max(best, sum(
                e.device_type != DeviceType.CPU and not e.is_user_annotation
                and e.id in launched for e in events))
    return best


def measure_dispatch_ts(dev: torch.device, n_calls: int = 300) -> float:
    """Marginal dispatch latency of the near-zero-work task, seconds."""
    step, x = _work_fn(0, dev)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        x = step(x)
    _sync(dev)
    return (time.perf_counter() - t0) / n_calls


def fit_dispatch_latency(dev: torch.device,
                         n_values=(10, 30, 100, 300)) -> ModelFit:
    """The paper's fit Delta_T = t_s n^alpha_s over n near-zero-work
    dispatches queued back to back, one synchronise at the end."""
    step, x = _work_fn(0, dev)
    dts = []
    for n in n_values:
        t0 = time.perf_counter()
        for _ in range(n):
            x = step(x)
        _sync(dev)
        dts.append(time.perf_counter() - t0)
    return fit_power_law(n_values, dts)


def utilization_curve(dev: torch.device, reps: int = 100, rounds: int = 4):
    """U against task time: per-task dispatch (wait for every task) vs
    aggregated (``reps`` tasks queued, one wait). The regimes take turns,
    ``rounds`` windows of ``reps`` tasks each, in the order per-task then
    aggregated, then the reverse, so a drift of the host's speed falls on
    both alike; each regime's time is its mean over all its windows, and
    ``utilization_rounds`` holds each round's own U."""
    t_s = measure_dispatch_ts(dev)
    rows = []
    for scale in SCALES:
        step, x = _work_fn(scale, dev)

        def per_task():
            y = x
            t0 = time.perf_counter()
            for _ in range(reps):
                y = step(y)
                _sync(dev)        # per-task dispatch: wait for every task
            return time.perf_counter() - t0

        def aggregated():
            y = x
            t0 = time.perf_counter()
            for _ in range(reps):
                y = step(y)       # aggregated: the device's queue
            _sync(dev)
            return time.perf_counter() - t0

        windows = []
        for r in range(rounds):
            order = (per_task, aggregated) if r % 2 == 0 else (aggregated,
                                                               per_task)
            t = {f: f() for f in order}
            windows.append((t[per_task], t[aggregated]))
        t_task = sum(w[0] for w in windows) / (rounds * reps)
        t_agg = sum(w[1] for w in windows) / (rounds * reps)
        # measured U of the per-task regime (the aggregated time is the
        # pure work) against the model with the independently measured t_s
        rows.append({
            "flops_scale": scale,
            "t_task_ms": t_task * 1e3,
            "t_aggregated_ms": t_agg * 1e3,
            "utilization_per_task_dispatch": t_agg / t_task,
            "model_U": float(utilization_approx(t_agg, t_s)),
            "utilization_rounds": [a / t for t, a in windows],
        })
    # profiled after every timing, so no profiler session precedes one
    for row in rows:
        row["launches_per_task"] = launches_per_task(
            *_work_fn(row["flops_scale"], dev), dev)
    return t_s, rows


def executor_latency(dev: torch.device, n_tasks: int = 300) -> dict:
    """The near-zero-work task run ``n_tasks`` times through
    ``TorchDispatchExecutor``, which waits for the device after each:
    mean seconds a task, and how many completed ok."""
    step, x = _work_fn(0, dev)
    ex = TorchDispatchExecutor()
    outcomes = []
    t0 = time.perf_counter()
    for i in range(n_tasks):
        ex.run(Task(0, i, payload=lambda: step(x)), outcomes.append)
    mean_s = (time.perf_counter() - t0) / n_tasks
    return {"tasks": n_tasks, "ok": sum(outcomes), "mean_s": mean_s,
            "errors": len(ex.errors)}


def run(device="cuda", quiet: bool = False):
    """t_s and the utilisation rows, printed as CSV unless ``quiet``."""
    dev = resolve_device(device)
    t_s, rows = utilization_curve(dev)
    if not quiet:
        print(f"# Real PyTorch dispatch latency on {dev} (eager t_s)")
        print(f"torch_dispatch_ts_us,{t_s * 1e6:.1f}")
        print("flops_scale,t_task_ms,t_agg_ms,U_per_task_dispatch,"
              "model_U,launches_per_task")
        for r in rows:
            print(f"{r['flops_scale']},{r['t_task_ms']:.3f},"
                  f"{r['t_aggregated_ms']:.3f},"
                  f"{r['utilization_per_task_dispatch']:.3f},"
                  f"{r['model_U']:.3f},{r['launches_per_task']}")
    return t_s, rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    fit = fit_dispatch_latency(dev)
    ex = executor_latency(dev)
    run(dev)   # last: it ends in profiler sessions
    print(f"fit over queued dispatches: {fit}")
    print(f"executor: {ex['tasks']} near-zero-work tasks, "
          f"{ex['mean_s'] * 1e6:.1f} us each (dispatch + wait)")


if __name__ == "__main__":
    main()

"""Host cost of a fixed cuBLAS workspace on the dispatch task.

``chip_smoke.py`` sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA
starts (deterministic cuBLAS for its fault phase), so every phase after
it, the dispatch and scheduler phases included, runs its matrix products
under that setting. This script times the dispatch benchmark's task
(``tanh(x @ x)`` on a 128 x 128 float32 matrix, ``scale`` times) in two
child processes, one with the variable unset and one with it set: the
wall us a task with ``n`` tasks queued back to back and one wait, and
with every task waited for.

  PYTHONPATH=src python -m repro_torch.bench.cublas_workspace [--device cpu]

Prints one JSON line a setting; writes no file. Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SETTINGS = (None, ":4096:8")
SCALES = (1, 16)


def measure(device: str, n: int = 2048, rounds: int = 2) -> dict:
    """{scale: {"queued_us", "synced_us"}}: means over ``rounds`` rounds
    of ``n`` tasks, each on its own seeded input."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.bench import dispatch_latency as dl

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn((n, dl.D, dl.D), generator=gen, device=dev) \
        * dl.D ** -0.5
    out = {}
    for scale in SCALES:
        step, _ = dl._work_fn(scale, dev)
        queued = synced = 0.0
        for _ in range(rounds):
            dl._sync(dev)
            t0 = time.perf_counter()
            res = [step(xs[i]) for i in range(n)]
            dl._sync(dev)
            queued += time.perf_counter() - t0
            del res
            t0 = time.perf_counter()
            for i in range(n):
                step(xs[i])
                dl._sync(dev)
            synced += time.perf_counter() - t0
        out[scale] = {"queued_us": queued / (rounds * n) * 1e6,
                      "synced_us": synced / (rounds * n) * 1e6}
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(measure(args.device)))
        return []
    rows = []
    for setting in SETTINGS:
        env = dict(os.environ)
        env.pop("CUBLAS_WORKSPACE_CONFIG", None)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(Path(__file__).resolve().parents[2])]
            + [q for q in [env.get("PYTHONPATH")] if q])
        if setting is not None:
            env["CUBLAS_WORKSPACE_CONFIG"] = setting
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.bench.cublas_workspace",
             "--child", "--device", args.device],
            env=env, capture_output=True, text=True, check=True)
        row = {"CUBLAS_WORKSPACE_CONFIG": setting,
               "tasks": json.loads(proc.stdout.strip().splitlines()[-1])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on this machine's cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Loads the cell's configuration, traffic mix, driver and metrics by name
(``registry.py``), sets up and warms up, measures for ``--seconds``
seconds, checks what the timed path produced against the plain reference
(``correct``), and prints one JSON object as its last line on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``, each number
compared beside its limit (also the last lines on standard error).

Exits 2 without a result where CUDA is missing or the cell asks for more
cards than there are, and 3 if JAX or the JAX package was loaded. Build
and kernel caches live at fixed paths under the checkout's ``build/``;
traces and logs go to ``build/perfbench/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
OUT = BUILD / "perfbench"
# every cache of the program and of PyTorch at a fixed path in the checkout
# (the kernels' own is the port's fixed build/kernels/)
CACHES = {"TRITON_CACHE_DIR": BUILD / "triton",
          "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": BUILD / "inductor",
          "CUDA_CACHE_PATH": BUILD / "cuda_cache"}


def prepare() -> None:
    """Before torch is imported: the caches' directories, no JAX for any
    library that would load it, and the checkout and its ``src`` on the
    import path."""
    for var, path in CACHES.items():
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's, Flax's or the JAX package's, compared whole (``repro_torch`` is
    not ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _override(base: dict, changes: dict) -> dict:
    out = dict(base)
    for k, v in (changes or {}).items():
        out[k] = _override(out.get(k, {}), v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def make_context(workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: float = None,
                 overrides: dict = None, bench: dict = None):
    """(context for the cell's driver, the cell, its limits). ``overrides``
    (for tests at small sizes) change the configuration's ``model``, the
    ``mix`` and the ``limits``."""
    from perfbench import registry
    from repro_torch.configs.base import ModelConfig

    bench = bench or registry.benchmark()
    cell = registry.workload(workload, bench)
    overrides = overrides or {}
    cfg_file = registry.config(cell["config"], bench)
    cfg = _override(cfg_file["model"], overrides.get("model"))
    mix = _override(registry.mix(cell["traffic"]), overrides.get("mix"))
    limits = _override(registry.limits(workload), overrides.get("limits"))
    ctx = SimpleNamespace(
        workload=workload, seed=seed, seconds=seconds, trace=trace,
        device=device, t_start=T_START if t_start is None else t_start,
        cfg=cfg, model_cfg=ModelConfig(**cfg), mix=mix,
        ref=registry.reference(cfg_file["reference"]), control=None,
        trace_path=OUT / f"{workload}.trace.json")
    return ctx, cell, limits


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None,
             overrides: dict = None, bench: dict = None):
    """One run of a cell; returns (the result object, notes for the
    log: the kernels' launches by body and what the check compared)."""
    import torch

    from perfbench import registry

    bench = bench or registry.benchmark()
    ctx, cell, limits = make_context(workload, seed, seconds, trace, device,
                                     t_start, overrides, bench)
    rec = registry.driver(ctx.mix["driver"]).run(ctx)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(workload, bench, section):
        value = registry.metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the numbers the cell's limits file names are compared; a number that
    # is not finite (a token outside the vocabulary, a reference norm of 0)
    # is written as null and fails
    checks = {name: {"value": rec.checks.get(name, math.inf),
                     "limit": limit["limit"]}
              for name, limit in limits.items()}
    for c in checks.values():
        if not math.isfinite(c["value"]):
            c["value"] = None
    correct = (rec.failed == 0 and rec.attempted > 0 and all(
        c["value"] is not None and c["limit"] is not None
        and c["value"] <= c["limit"] for c in checks.values()))
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(rec.memory_peak)}
    result = {"correct": bool(correct), "attempted": int(rec.attempted),
              "failed": int(rec.failed), "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.top_ops(10),
                               "idle_gaps": rec.trace.idle_gaps(10)}
    result["checks"] = checks
    notes = dict(rec.check_notes, counters=rec.counters,
                 not_compared={k: v for k, v in rec.checks.items()
                               if k not in limits})
    return result, notes


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    args = parse(argv)
    prepare()
    from perfbench import registry

    bench = registry.benchmark()
    cell = registry.workload(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, notes = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad} (JAX or the JAX package); no result",
              file=sys.stderr)
        return 3
    print(f"perfbench: card {_power_limit()}; {json.dumps(notes)}",
          file=sys.stderr)
    OUT.mkdir(parents=True, exist_ok=True)
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

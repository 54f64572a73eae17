#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 5 --out build/perfbench/calib.json

In one process, at the cell's own size and load:

- the program's reading of each compared number on every seed of
  ``--seeds``, each a run of the cell with a short window (``--seconds``);
- the control's on every seed of ``--control-seeds``: the reference put in
  the program's place and computed one precision below the
  configuration's (``control_for``: fp8 for bf16). Serving: on the
  prompts and served tokens of a run of the program, the gap of the token
  the lower precision puts first. Training: its three steps held against
  the float32 reference's;
- in a training cell, the fault "half of the batch left out, the mean
  taken over the rest", planted in the reference put in the program's
  place, on the control seeds. (A state left unchanged reads 1 by the
  change's measure and needs no run.)

Writes every reading, and per number the largest program reading (the
lower) and the smallest control and fault readings, to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as bench_run  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", type=json.loads, default=None,
                    help="JSON: changes to the model, mix and limits "
                    "(tests at small sizes)")
    args = ap.parse_args(argv)
    bench_run.prepare()
    import torch

    from perfbench import registry

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    out = {"workload": args.workload, "program": {}, "control": {},
           "faults": {}}
    if args.device == "cuda":
        out["card"] = bench_run._power_limit()

    def save():
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))

    for seed in args.seeds + [s for s in args.control_seeds
                              if s not in args.seeds]:
        t = time.perf_counter()
        ctx, _, _ = bench_run.make_context(args.workload, seed, args.seconds,
                                           False, args.device, t,
                                           args.overrides)
        kind = ctx.mix["driver"]
        if kind == "serve" and seed in args.control_seeds:
            ctx.control = ctx.ref.control_for(ctx.cfg)
        if seed in args.seeds or kind == "serve":
            rec = registry.driver(kind).run(ctx)
            out["program"][str(seed)] = rec.checks
            if getattr(rec, "control", None):
                out["control"][str(seed)] = rec.control
        if kind == "train" and seed in args.control_seeds:
            out["control"][str(seed)], out["faults"][str(seed)] = \
                _train_controls(ctx)
        print(f"calibrate {args.workload} seed {seed}: "
              f"{json.dumps(out['program'].get(str(seed)))} control "
              f"{json.dumps(out['control'].get(str(seed)))} fault "
              f"{json.dumps(out['faults'].get(str(seed)))} "
              f"({time.perf_counter() - t:.1f} s)", file=sys.stderr)
        save()
    names = sorted({k for r in out["program"].values() for k in r})
    out["summary"] = {n: {
        "lower": max(r[n] for r in out["program"].values()),
        "control": min((r[n] for r in out["control"].values() if n in r),
                       default=None),
        "half_batch": min((r["half_batch"][n]
                           for r in out["faults"].values()), default=None)}
        for n in names}
    save()
    print(json.dumps(out["summary"]), file=sys.stderr)
    return 0


def _train_controls(ctx):
    """(the control's numbers: the reference one precision below the
    configuration's; the half-batch fault's numbers), each against the
    float32 reference's three steps."""
    from perfbench import registry, traffic

    drv = registry.driver("train")
    mix, dev = ctx.mix, ctx.device
    vocab = ctx.cfg["vocab_size"]

    def batches():
        return (traffic.train_batch(mix, ctx.seed, j, vocab, dev)
                for j in range(1, mix["check_steps"] + 1))

    rows = mix["reference_block_rows"]
    ref = ctx.ref.adamw_steps(ctx.cfg, ctx.seed, mix, batches(), dev,
                              block_rows=rows)
    low = ctx.ref.adamw_steps(ctx.cfg, ctx.seed, mix, batches(), dev,
                              quant=ctx.ref.control_for(ctx.cfg),
                              block_rows=rows)
    half = ctx.ref.adamw_steps(ctx.cfg, ctx.seed, mix, batches(), dev,
                               rows=mix["batch"] // 2, block_rows=rows)
    return drv.compare(low, ref), {"half_batch": drv.compare(half, ref)}


if __name__ == "__main__":
    sys.exit(main())

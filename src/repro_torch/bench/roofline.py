"""Roofline report: per (arch x shape x mesh) compute/memory/collective
terms from the port's dry-run records (experiments/dryrun_torch/*.json).

The counterpart of the reference's ``benchmarks/roofline.py``, against one
NVIDIA H100 SXM5's peaks (``launch/dryrun.py``): 989.4 TFLOP/s dense bf16,
3.35 TB/s HBM3, 50 GB/s of collective link. The dominant term is the
bottleneck; ``useful_flops_ratio`` is model FLOPs over the counted FLOPs
per device (recomputation and masked blocks show up here).

  PYTHONPATH=src python -m repro_torch.bench.roofline [TAG] [--dir DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import DEFAULT_OUT, PEAK_FLOPS

HEADER = ("arch,shape,mesh,status,compute_s,memory_s,collective_s,dominant,"
          "useful_flops_ratio,hbm_args_gb")


def load_cells(tag: str = "", root: str = DEFAULT_OUT):
    cells = []
    for p in sorted(Path(root).glob("*.json")):
        parts = p.stem.split("__")
        if tag and (len(parts) < 4 or parts[3] != tag):
            continue
        if not tag and len(parts) > 3:
            continue
        cells.append(json.loads(p.read_text()))
    return cells


def run(quiet: bool = False, tag: str = "", root: str = DEFAULT_OUT):
    """Print the table (CSV after a comment line); returns the ok rows."""
    cells = load_cells(tag, root)
    print("# Roofline table (per-device terms, seconds per step; H100)")
    print(HEADER)
    rows = []
    for c in cells:
        if c["status"] != "ok":
            print(f"{c['arch']},{c['shape']},{c['mesh']},{c['status']},,,,,,")
            continue
        t = c["roofline"]
        mem_gb = c["memory"]["argument_bytes"] / 2 ** 30
        print(f"{c['arch']},{c['shape']},{c['mesh']},ok,"
              f"{t['compute_s']:.4g},{t['memory_s']:.4g},"
              f"{t['collective_s']:.4g},{c['dominant']},"
              f"{c['useful_flops_ratio']:.3f},{mem_gb:.2f}")
        rows.append(c)
    train = [r for r in rows if r["shape"].startswith("train")]
    if train and not quiet:
        worst = min(train, key=_roofline_fraction)
        print(f"# worst train-cell roofline fraction: {worst['arch']} "
              f"{worst['shape']} {worst['mesh']} "
              f"frac={_roofline_fraction(worst):.3f}")
    return rows


def _roofline_fraction(cell) -> float:
    """Fraction of roofline achieved: ideal-compute-time / bound-time."""
    t = cell["roofline"]
    ideal = cell["model_flops_per_device"] / PEAK_FLOPS
    bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
    return ideal / bound if bound else 0.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tag", nargs="?", default="")
    ap.add_argument("--dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    run(tag=args.tag, root=args.dir)


if __name__ == "__main__":
    main()

"""Multi-pod dry run: run every (arch x shape x mesh) step on a fake mesh.

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for 512 fake XLA devices. Here each cell runs its step
eagerly over a fake process group of the mesh's size (every collective
returns at once; ``torch.testing._internal.distributed.fake_pg``), on
``meta`` tensors (shapes and dtypes, no memory): parameters, AdamW's
moments, the batch and the caches of the full-size config are DTensors
laid out by the port's specs (``launch/steps.py``). That proves the
distribution config coherent (every sharding legal, every operation and
collective supported under DTensor) and gives the roofline inputs: one
device's FLOPs, bytes and collective bytes from ``launch/op_analysis.py``
(loops rolled, see there), the collectives as ``CommDebugMode`` saw them
dispatched, and the bytes of one device's argument shards. Kernels are
off (``use_kernel=False``), as the reference's dry run runs
``use_pallas=False``.

Peaks are the H100's: one device's terms are FLOPs over 989.4 TFLOP/s,
bytes over 3.35 TB/s and collective bytes over 50 GB/s. One record a cell
lands in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma_2b --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.configs import (ARCH_IDS, ASSIGNED_SHAPES, SHAPES_BY_NAME,
                                 get_config, get_smoke_config, supports_shape)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.launch.steps import build_step

# ---------------------------------------------------------------------------
# Hardware model (NVIDIA H100 SXM5 80 GB, per device)
# ---------------------------------------------------------------------------

# dense bf16 tensor-core FLOP/s: NVIDIA H100 Tensor Core GPU datasheet,
# H100 SXM column (989.4 TFLOPS without sparsity), 700 W
PEAK_FLOPS = 989.4e12
# HBM3 bytes/s: the same datasheet, H100 SXM (3.35 TB/s)
HBM_BW = 3.35e12
# one collective rate: a 16-wide axis crosses HGX nodes of 8 GPUs, so its
# link is one 400 Gb/s NDR InfiniBand port per GPU (50 GB/s)
LINK_BW = 50e9
HBM_BYTES = 80e9

DEFAULT_OUT = "experiments/dryrun_torch"
SKIP_REASON = ("long_500k requires sub-quadratic attention "
               "(see DESIGN.md §Arch-applicability)")


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float) -> dict:
    """One device's seconds a step on each roof."""
    return {"compute_s": flops / PEAK_FLOPS,
            "memory_s": bytes_accessed / HBM_BW,
            "collective_s": coll_bytes / LINK_BW}


def mesh_geometry(mesh_kind: str):
    """(shape, axes) of "single" (16, 16), "multi" (2, 16, 16) or an
    explicit "AxB" / "AxBxC" (data, model) / (pod, data, model)."""
    if mesh_kind in ("single", "multi"):
        return mesh_lib.PRODUCTION[mesh_kind == "multi"]
    shape = tuple(int(n) for n in mesh_kind.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    return shape, axes


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_lib.leaves(tree):
        if torch.is_tensor(t):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


def _comm_counts(comm) -> dict:
    return {str(op).split(".")[-1]: int(n)
            for op, n in comm.get_comm_counts().items() if n}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             extra_tag: str = "", smoke: bool = False,
             roll: bool = True) -> dict:
    """Dry-run one cell and write its record. ``smoke`` takes the reduced
    config; ``roll=False`` runs every loop iteration."""
    cfg = (get_smoke_config if smoke else get_config)(arch)
    shape = SHAPES_BY_NAME[shape_name]
    return _run(cfg, arch, shape, mesh_kind, Path(out_dir), extra_tag, smoke,
                roll)


def _run(cfg, arch, shape, mesh_kind, out_dir, extra_tag, smoke, roll):
    from torch.distributed.tensor.debug import CommDebugMode

    shape_name = shape.name
    if not supports_shape(cfg, shape):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": SKIP_REASON}
        _write(out_dir, rec, extra_tag)
        return rec
    mshape, axes = mesh_geometry(mesh_kind)
    chips = math.prod(mshape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": dict(zip(axes, mshape)), "chips": chips,
           "smoke": smoke, "status": "ok"}
    owned = not dist.is_initialized()
    t0 = time.time()
    try:
        if owned:
            mesh_lib.init_group("fake", chips)
        elif (dist.get_backend(), dist.get_world_size()) != ("fake", chips):
            raise RuntimeError(
                f"a {dist.get_backend()} group of world size "
                f"{dist.get_world_size()} is set up; the dry run of a "
                f"{chips}-device mesh needs a fake group of that size")
        mesh = mesh_lib.make_mesh(mshape, axes, device="cpu")
        built = build_step(cfg, mesh, shape)
        args = built.args()
        t_build = time.time() - t0
        with OpAnalysis(roll=roll, device="meta") as analysis, \
                CommDebugMode() as comm:
            out = built.fn(*args)
        hc = analysis.cost
        flops = hc.dot_flops + hc.elementwise_flops
        terms = roofline_terms(flops, hc.traffic_bytes, hc.collective_bytes)
        pc = cfg.param_count()
        tokens = shape.global_batch * (shape.seq_len if shape.kind in (
            "train", "prefill") else 1)
        model_flops = (6 if shape.kind == "train" else 2) * pc["active"] \
            * tokens
        arg_bytes = _local_bytes(args)
        rec.update({
            "build_s": t_build, "run_s": time.time() - t0 - t_build,
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": _local_bytes(out),
                       "argument_share_of_hbm": arg_bytes / HBM_BYTES},
            "op_flops_per_device": flops,
            "op_bytes_per_device": hc.traffic_bytes,
            "op_detail": hc.as_dict(),
            "collectives_dispatched": _comm_counts(comm),
            "roofline": terms,
            "peaks": {"flops": PEAK_FLOPS, "hbm_bytes_s": HBM_BW,
                      "link_bytes_s": LINK_BW},
            "model_flops_total": model_flops,
            "model_flops_per_device": model_flops / chips,
            "useful_flops_ratio": (model_flops / chips) / flops if flops
            else 0.0,
            "dominant": max(terms, key=terms.get),
            "params_total": pc["total"], "params_active": pc["active"],
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        if owned:
            mesh_lib.destroy_group()
    _write(out_dir, rec, extra_tag)
    return rec


def _write(out_dir: Path, rec: dict, extra_tag: str = "") -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"__{extra_tag}" if extra_tag else ""
    path = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    path.write_text(json.dumps(rec, indent=1, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    help="single, multi, both, or an explicit AxB[xC]")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configs at the same shapes")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in ASSIGNED_SHAPES] if args.shape == "all"
              else args.shape.split(","))
    meshes = (["single", "multi"] if args.mesh == "both"
              else args.mesh.split(","))
    out_dir = Path(args.out)
    t00 = time.time()
    failed = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"__{args.tag}" if args.tag else ""
                p = out_dir / f"{arch}__{shape}__{mesh_kind}{tag}.json"
                if args.skip_existing and p.exists():
                    print(f"[skip] {p.name}")
                    continue
                rec = run_cell(arch, shape, mesh_kind, out_dir,
                               extra_tag=args.tag, smoke=args.smoke)
                print(f"[{rec['status']:7s}] {arch:22s} {shape:12s} "
                      f"{mesh_kind:6s} run={rec.get('run_s', 0):.2f}s "
                      f"dom={rec.get('dominant', '-')} "
                      f"args={rec.get('memory', {}).get('argument_bytes', 0)} "
                      f"({time.time() - t00:.0f}s elapsed)", flush=True)
                if rec["status"] == "failed":
                    failed += 1
                    print(rec["error"], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

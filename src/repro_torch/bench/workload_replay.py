"""Workload replay CLI: stream a trace or synthetic family through the
port's virtual-clock scheduler and report control-plane metrics.

The driver for the workload subsystem (``repro_torch.workloads``): pick a
source — an SWF trace file or a named synthetic family — and it feeds the
StreamingInjector, attaches the shared MetricsTap, and prints/records
{jobs, tasks, wall s, tasks/s, peak materialized jobs, dispatch-latency
percentiles, utilization}.  Peak materialized state is the headline number:
the injector holds one spec of lookahead and an active-job cap, so a
million-task stream runs in O(P)-bounded memory (the reference's run of
the same stream is committed as ``experiments/workload_stream_1M.json``;
this driver reproduces every field of it but the wall clock's).

Usage:
    PYTHONPATH=src python -m repro_torch.bench.workload_replay \
        --swf tests/fixtures/sample.swf
    PYTHONPATH=src python -m repro_torch.bench.workload_replay \
        --family poisson --jobs 5000 --P 256
    PYTHONPATH=src python -m repro_torch.bench.workload_replay \
        --family poisson --jobs 250000 --tasks-per-job 4 --P 1024 \
        --max-active 2048 --out stream_1M.json        # the 1M-task run
    PYTHONPATH=src python -m repro_torch.bench.workload_replay --quick

The summary JSON is written only to the file ``--out`` names; ``--html``
writes the dashboard's static report, ``--dashboard`` renders frames to
stderr during the run.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.core import FAMILIES as PROFILES
from repro_torch.core import ResourceManager, Scheduler
from repro_torch.obs import Dashboard
from repro_torch.workloads import (MetricsTap, StreamingInjector,
                                   SYNTHETIC_FAMILIES, jobs_from_swf,
                                   synthetic_stream, validate_stream)
from repro_torch.workloads.synthetic import poisson_family

ROOT = Path(__file__).resolve().parents[3]
FIXTURE = ROOT / "tests" / "fixtures" / "sample.swf"


def build_cluster(P: int, profile: str) -> Scheduler:
    rm = ResourceManager()
    rm.add_nodes(P, slots=1)
    rm.add_license("lic", max(P // 8, 1))   # license_mix family consumable
    return Scheduler(rm, profile=PROFILES[profile])


def replay(source, P: int = 256, profile: str = "inproc",
           max_active: int = 0, label: str = "replay",
           dashboard: bool = False, html: Path = None) -> dict:
    sch = build_cluster(P, profile)
    tap = MetricsTap()
    inj = StreamingInjector(sch, source, max_active_jobs=max_active, tap=tap)
    dash = None
    if dashboard or html:
        # batch-only chaining: attached after the tap, it neither triggers
        # the tap's clobber-replay nor leaves the wave-batched hot path
        dash = Dashboard(tap.registry, tap=tap).attach(sch)
    w0 = time.time()
    inj.run()
    wall = time.time() - w0
    if dash is not None:
        dash.finish()
        if html:
            dash.export_html(html, title=label)
            print(f"-> {html}")
    if not inj.drained:
        raise RuntimeError(f"{label}: stream did not drain "
                           f"({sch.active_jobs} jobs still active)")
    util = sch.utilization() if sch.stats else 0.0
    out = {
        "label": label, "P": P, "profile": profile,
        "max_active_jobs": max_active,
        "jobs": inj.submitted_jobs, "tasks": inj.submitted_tasks,
        "peak_active_jobs": inj.peak_active_jobs,
        "wall_s": round(wall, 3),
        "tasks_per_s": round(inj.submitted_tasks / max(wall, 1e-9), 1),
        "virtual_makespan_s": sch.loop.now,
        "utilization": util,
        **tap.summary(),
    }
    return out


def show(r: dict) -> None:
    print(f"{r['label']}: {r['jobs']} jobs / {r['tasks']} tasks on "
          f"P={r['P']} in {r['wall_s']}s wall "
          f"({r['tasks_per_s']:.0f} tasks/s)")
    print(f"  peak materialized jobs {r['peak_active_jobs']} "
          f"(cap {r['max_active_jobs'] or 'none'}), "
          f"virtual makespan {r['virtual_makespan_s']:.1f}s, "
          f"U={r['utilization']:.3f}")
    print(f"  dispatch latency mean {r['dispatch_latency_mean_s']:.4g}s "
          f"p50 {r['dispatch_latency_p50_s']:.4g}s "
          f"p99 {r['dispatch_latency_p99_s']:.4g}s "
          f"max {r['dispatch_latency_max_s']:.4g}s")


def quick() -> int:
    """Smoke: one synthetic family + the SWF fixture, small and fast."""
    r1 = replay(synthetic_stream(seed=0, n_jobs=300, rate=32.0),
                P=64, max_active=128, label="poisson_smoke")
    show(r1)
    assert r1["jobs"] == 300 and r1["peak_active_jobs"] <= 128, r1
    r2 = replay(validate_stream(jobs_from_swf(FIXTURE)),
                P=64, label="swf_fixture")
    show(r2)
    assert r2["jobs"] == 11, r2      # 12 rows, one failed-at-submit skipped
    assert r2["tasks"] == sum((4, 8, 1, 16, 2, 4, 32, 1, 8, 4, 2)), r2
    print("workload replay smoke OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--swf", type=Path, help="replay an SWF trace file")
    ap.add_argument("--gang", action="store_true",
                    help="SWF jobs as gang-parallel (rigid) jobs")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="compress/dilate SWF arrivals and runtimes")
    ap.add_argument("--family", choices=sorted(SYNTHETIC_FAMILIES),
                    help="replay a named synthetic family")
    ap.add_argument("--jobs", type=int, default=2000,
                    help="synthetic stream length (jobs)")
    ap.add_argument("--tasks-per-job", type=int, default=4,
                    help="array width (poisson family only; the other "
                         "families define their own shape mixes)")
    ap.add_argument("--P", type=int, default=256, help="cluster slots")
    ap.add_argument("--profile", default="inproc",
                    choices=sorted(PROFILES),
                    help="scheduler-family latency profile")
    ap.add_argument("--max-active", type=int, default=0,
                    help="injector backpressure: max jobs in flight")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, help="write the summary JSON here")
    ap.add_argument("--dashboard", action="store_true",
                    help="live terminal dashboard (stderr) during the run")
    ap.add_argument("--html", type=Path,
                    help="write a static HTML report of the run here")
    ap.add_argument("--quick", action="store_true", help="smoke run")
    args = ap.parse_args(argv)

    if args.quick:
        return quick()
    if args.swf:
        src = validate_stream(jobs_from_swf(
            args.swf, gang=args.gang, time_scale=args.time_scale))
        label = f"swf:{args.swf.name}"
    elif args.family:
        if args.family != "poisson" and args.tasks_per_job != 4:
            ap.error("--tasks-per-job only applies to --family poisson; "
                     f"{args.family!r} defines its own shape mix")
        if args.family == "poisson":
            # the only family with a tunable array width (the 1M-task run
            # uses --jobs 250000 --tasks-per-job 4)
            src = poisson_family(args.seed, args.jobs, args.P,
                                 tasks_per_job=args.tasks_per_job)
        else:
            src = SYNTHETIC_FAMILIES[args.family](
                args.seed, args.jobs, args.P)
        label = f"family:{args.family}"
    else:
        ap.error("pick a source: --swf, --family, or --quick")
    r = replay(src, P=args.P, profile=args.profile,
               max_active=args.max_active, label=label,
               dashboard=args.dashboard, html=args.html)
    show(r)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(r, indent=2) + "\n")
        print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

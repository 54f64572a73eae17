"""Fault replay: Table-9 task sets under deterministic failure injection.

The paper's feature analysis puts resilience (fault tolerance,
restartability) among the defining scheduler features; this benchmark
measures what churn actually costs on the paper's own experiment grid.  It
sweeps node MTBF over the P=1408 constant-time task sets and reports, per
cell, the quantities the fault plane makes measurable in virtual time:

* makespan stretch — ``T_total`` vs. the committed no-fault baseline
  (``experiments/bench_cache.json``, the reference's run), i.e.
  utilization degradation vs MTBF;
* goodput fraction — completed task-seconds over completed + discarded
  (work thrown away by node deaths mid-task);
* retry traffic — requeues, quarantined poison tasks, permanently failed
  jobs;
* detection latency — for silent-death cells, virtual seconds from death
  to heartbeat-sweep detection (bounded by timeout + sweep interval);
* node downtime — total node-seconds spent DOWN.

Two invariants are asserted on every invocation, not just in tests:

* the no-fault row is bit-identical to the committed bench cache (the fault
  plane must cost *nothing* when idle);
* chaos is deterministic — the same (workload, fault-seed) cell replayed
  twice, and replayed with wave batching disabled, produces the identical
  row, requeue-for-requeue (``--quick`` runs exactly this as the smoke).

A port of the reference's ``benchmarks/fault_replay.py`` onto
``repro_torch``: its full sweep at P=1408 reproduces the committed
``experiments/fault_replay_P1408.json`` in every field but ``wall_s``.
The artifact is written only to the file ``--out`` names.

Usage:
    PYTHONPATH=src python -m repro_torch.bench.fault_replay --out sweep.json
    PYTHONPATH=src python -m repro_torch.bench.fault_replay --quick
    PYTHONPATH=src python -m repro_torch.bench.fault_replay \
        --sets medium --mtbf 4000
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from pathlib import Path
from typing import Dict, Optional, Tuple

from repro_torch.bench.common import CACHE, P, TASK_SETS
from repro_torch.core import (FAMILIES, FaultPlane, FaultProfile, JobState,
                              ResourceManager, Scheduler, SchedulerConfig)
from repro_torch.obs import Dashboard
from repro_torch.workloads import (FAULT_PROFILES, MetricsTap,
                                   StreamingInjector, constant_taskset)

#: default MTBF sweep (virtual seconds per node); cluster-wide failure rate
#: is P/mtbf, so at P=1408 this spans ~0.09 .. ~0.7 failures/s
MTBF_SWEEP: Tuple[float, ...] = (16000.0, 8000.0, 4000.0, 2000.0)

# retry lifecycle used for every faulted cell: generous budget, exponential
# backoff from 0.5 s, poison quarantine after 5 fault coincidences
MAX_RESTARTS = 8
RETRY_BACKOFF = 0.5
QUARANTINE_AFTER = 5


def run_cell(family: str, t: float, n: int, procs: int,
             fault_profile: Optional[FaultProfile] = None, *,
             fault_seed: int = 0, heartbeat_interval: float = 0.0,
             wave_batching: bool = True,
             set_name: str = "set",
             dashboard: bool = False) -> Tuple[Dict, Dict]:
    """One (task set, fault regime) run.

    Returns ``(row, signature)``: the row is the JSON-artifact record; the
    signature additionally carries the full tap/plane summaries (including
    the sampled time series) and is what the determinism asserts compare.
    No-fault cells use a default ``SchedulerConfig`` so they stay on the
    exact code path the committed bench cache was produced by.
    """
    rm = ResourceManager()
    rm.add_nodes(procs, slots=1)
    if fault_profile is None:
        cfg = SchedulerConfig(wave_batching=wave_batching)
    else:
        cfg = SchedulerConfig(
            wave_batching=wave_batching,
            heartbeat_interval=heartbeat_interval,
            retry_backoff=RETRY_BACKOFF,
            quarantine_after=QUARANTINE_AFTER)
    s = Scheduler(rm, profile=FAMILIES[family], config=cfg)
    failed_jobs = [0]

    def _job_done(job):
        if job.state is JobState.FAILED:
            failed_jobs[0] += 1

    s.on_job_done = _job_done           # tap chains this below
    tap = MetricsTap()
    restarts = 0 if fault_profile is None else MAX_RESTARTS
    source = constant_taskset(
        t, n, procs, name=f"{family}-{set_name}", max_restarts=restarts)
    inj = StreamingInjector(s, source, tap=tap)
    plane = (FaultPlane(s, fault_profile, seed=fault_seed)
             if fault_profile is not None else None)
    dash = None
    if dashboard:
        dash = Dashboard(tap.registry, tap=tap).attach(s)
        if plane is not None:
            dash.registry.bind_fault_plane(plane)
    w0 = time.time()
    inj.run()
    wall = time.time() - w0
    if dash is not None:
        dash.finish()
    assert inj.drained, "task set did not drain"

    sts = list(s.stats.values())
    T_total = (max(st.last_end for st in sts)
               - min(st.submit_time for st in sts))
    T_job = t * n
    tap_summary = tap.summary()
    plane_summary = plane.summary() if plane is not None else {}
    row = {
        "set": set_name, "family": family, "t": t, "n": n, "P": procs,
        "fault_profile": fault_profile.name if fault_profile else "none",
        "mtbf": fault_profile.mtbf if fault_profile else 0.0,
        "fault_seed": fault_seed if fault_profile else None,
        "heartbeat_interval": heartbeat_interval,
        "T_total": T_total, "T_job": T_job, "delta_t": T_total - T_job,
        "utilization": T_job / T_total,
        "goodput_fraction": tap_summary["goodput_fraction"],
        "lost_work_s": tap_summary["lost_work_s"],
        "requeues": tap_summary["requeues"],
        "quarantined": tap_summary["quarantined"],
        "failed_jobs": failed_jobs[0],
        "dispatches": tap_summary["dispatches"],
        "wall_s": wall,
    }
    if plane is not None:
        row["injected"] = plane_summary["injected"]
        row["recoveries"] = plane_summary["recoveries"]
        row["detection_latency_s"] = plane_summary["detection_latency_s"]
        row["false_positives"] = plane_summary["false_positives"]
        row["downtime_node_s"] = plane_summary["downtime_node_s"]
    # deterministic signature: everything observable, wall clock excluded
    signature = {k: v for k, v in row.items() if k != "wall_s"}
    signature["tap"] = {k: v for k, v in tap_summary.items()}
    signature["plane"] = plane_summary
    return row, signature


def check_baseline_row(row: Dict) -> str:
    """Cross-check a no-fault row against the committed bench cache.

    Bit-exact equality is the contract: an idle fault plane (and the dead
    config knobs it activates) must not perturb the hot path at all.
    """
    if not CACHE.exists():
        return "cache-absent"
    cache = json.loads(CACHE.read_text())
    key = f"{row['family']}|{row['n']}|{row['t']}|0|0"
    if key not in cache:
        return "key-absent"
    if cache[key]["T_total"] != row["T_total"]:
        raise SystemExit(
            f"no-fault T_total diverged from committed baseline: "
            f"{row['T_total']!r} != {cache[key]['T_total']!r} ({key}) — "
            f"the fault plane must be free when no faults are injected")
    return "match"


def assert_deterministic(family: str, t: float, n: int, procs: int,
                         profile: FaultProfile, *, fault_seed: int,
                         heartbeat_interval: float = 0.0,
                         set_name: str = "set") -> Dict:
    """Replay one faulted cell three ways and require identical observables:
    twice on the wave path (replay determinism), once with wave batching
    off (wave/per-event equivalence under churn)."""
    kw = dict(fault_seed=fault_seed, heartbeat_interval=heartbeat_interval,
              set_name=set_name)
    _, sig_a = run_cell(family, t, n, procs, profile, **kw)
    _, sig_b = run_cell(family, t, n, procs, profile, **kw)
    _, sig_c = run_cell(family, t, n, procs, profile,
                        wave_batching=False, **kw)
    if sig_a != sig_b:
        raise SystemExit(f"chaos replay diverged across runs "
                         f"({set_name}, {profile.name}, seed {fault_seed})")
    if sig_a != sig_c:
        raise SystemExit(f"wave vs per-event paths diverged under churn "
                         f"({set_name}, {profile.name}, seed {fault_seed})")
    return {"set": set_name, "profile": profile.name,
            "fault_seed": fault_seed,
            "replay_identical": True, "wave_vs_per_event_identical": True}


def _fmt(row: Dict) -> str:
    det = row.get("detection_latency_s", {"n": 0, "mean": 0.0})
    return (f"{row['set']:>7} {row['fault_profile']:>16} "
            f"T_total={row['T_total']:10.3f}s "
            f"util={row['utilization']:.4f} "
            f"goodput={row['goodput_fraction']:.4f} "
            f"requeues={row['requeues']:5d} "
            f"lost={row['lost_work_s']:9.1f}s "
            f"det={det['mean']:6.2f}s(n={det['n']}) "
            f"[{row['wall_s']:.2f}s wall]")


def quick_smoke() -> Dict:
    """Chaos smoke: small grid, heavy churn, all determinism asserts.

    Covers: no-fault wave==per-event identity, faulted replay determinism,
    wave==per-event under announced churn and under silent deaths with
    heartbeat sweeps (detection latency must be measured, not zero).
    """
    procs, t, n = 96, 2.0, 6
    churn = replace(FAULT_PROFILES["churn"], mtbf=300.0, mttr=20.0,
                    name="quick_churn")
    silent = replace(FAULT_PROFILES["silent"], mtbf=400.0, mttr=30.0,
                     name="quick_silent")
    # no-fault: wave and per-event paths agree with the plane code present
    _, base_wave = run_cell("slurm", t, n, procs, set_name="quick")
    _, base_evt = run_cell("slurm", t, n, procs, wave_batching=False,
                           set_name="quick")
    if base_wave != base_evt:
        raise SystemExit("no-fault wave vs per-event paths diverged")
    checks = [assert_deterministic("slurm", t, n, procs, churn,
                                   fault_seed=seed, set_name="quick")
              for seed in (1, 2)]
    checks.append(assert_deterministic(
        "slurm", t, n, procs, silent, fault_seed=3,
        heartbeat_interval=5.0, set_name="quick"))
    row, sig = run_cell("slurm", t, n, procs, silent, fault_seed=3,
                        heartbeat_interval=5.0, set_name="quick")
    if sig["plane"]["injected"].get("silent", 0) > 0 \
            and row["detection_latency_s"]["n"] == 0:
        raise SystemExit("silent deaths injected but none detected — "
                         "heartbeat sweeps are not running")
    print("chaos smoke: no-fault identity OK, "
          f"{len(checks)} determinism cells OK, "
          f"detection latency mean "
          f"{row['detection_latency_s']['mean']:.2f}s "
          f"over {row['detection_latency_s']['n']} silent deaths")
    return {"quick": True, "P": procs, "checks": checks,
            "silent_detection": row["detection_latency_s"]}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="chaos smoke: small grid, determinism asserts")
    ap.add_argument("--P", type=int, default=P)
    ap.add_argument("--family", default="slurm", choices=sorted(FAMILIES))
    ap.add_argument("--sets", default="rapid,medium",
                    help="comma-separated Table-9 set names")
    ap.add_argument("--mtbf", type=float, action="append", default=None,
                    help="MTBF sweep point (repeatable); default "
                         f"{MTBF_SWEEP}")
    ap.add_argument("--fault-seed", type=int, default=1)
    ap.add_argument("--dashboard", action="store_true",
                    help="live terminal dashboard (stderr) during sweep "
                         "cells")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the JSON artifact here (by default nothing "
                         "is written)")
    args = ap.parse_args(argv)

    if args.quick:
        return quick_smoke()

    sets = {name: (tv, nv) for name, tv, nv in TASK_SETS}
    chosen = [sn.strip() for sn in args.sets.split(",") if sn.strip()]
    for sn in chosen:
        if sn not in sets:
            raise SystemExit(f"unknown set {sn!r}; choose from "
                             f"{sorted(sets)}")
    sweep = tuple(args.mtbf) if args.mtbf else MTBF_SWEEP
    rows = []
    for sn in chosen:
        t, n = sets[sn]
        row, _ = run_cell(args.family, t, n, args.P, set_name=sn,
                          dashboard=args.dashboard)
        row["baseline_check"] = (check_baseline_row(row)
                                 if args.P == P else "skipped")
        print(_fmt(row) + f"  baseline={row['baseline_check']}")
        rows.append(row)
        for mtbf in sweep:
            prof = replace(FAULT_PROFILES["churn"], mtbf=mtbf,
                           name=f"churn_mtbf{int(mtbf)}")
            row, _ = run_cell(args.family, t, n, args.P, prof,
                              fault_seed=args.fault_seed, set_name=sn,
                              dashboard=args.dashboard)
            print(_fmt(row))
            rows.append(row)
        silent = replace(FAULT_PROFILES["silent"], mtbf=8000.0,
                         name="silent_mtbf8000")
        row, _ = run_cell(args.family, t, n, args.P, silent,
                          fault_seed=args.fault_seed,
                          heartbeat_interval=5.0, set_name=sn,
                          dashboard=args.dashboard)
        print(_fmt(row))
        rows.append(row)
        rack = replace(FAULT_PROFILES["rack_outage"], domain_mtbf=8000.0,
                       name="rack_outage")
        row, _ = run_cell(args.family, t, n, args.P, rack,
                          fault_seed=args.fault_seed, set_name=sn,
                          dashboard=args.dashboard)
        print(_fmt(row))
        rows.append(row)

    # determinism gate on one mid-sweep cell (cheapest chosen set)
    sn = min(chosen, key=lambda s: sets[s][1] * args.P)
    t, n = sets[sn]
    det = assert_deterministic(
        args.family, t, n, args.P,
        replace(FAULT_PROFILES["churn"], mtbf=4000.0, name="churn_mtbf4000"),
        fault_seed=args.fault_seed, set_name=sn)
    print(f"determinism: replay + wave/per-event identical on "
          f"{sn}/churn_mtbf4000 seed {args.fault_seed}")

    result = {
        "P": args.P, "family": args.family,
        "retry": {"max_restarts": MAX_RESTARTS,
                  "retry_backoff": RETRY_BACKOFF,
                  "quarantine_after": QUARANTINE_AFTER},
        "mtbf_sweep": list(sweep),
        "rows": rows,
        "determinism": det,
    }
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
        print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()

"""Self-latency: measure OUR scheduler's (t_s, alpha_s) — real, not modeled.

The paper characterizes Slurm/SGE/Mesos/YARN by fitting the measured launch
overhead DT(n) = t_s * n^alpha_s over job size n (Figure 4).  Everywhere
else in this repo those four systems are *modeled* (``LatencyProfile``
charges their fitted costs in virtual time); this benchmark turns the
instrument on ourselves: it sweeps n at fixed P with an all-zero latency
profile — so virtual time contributes nothing and the measured wall-clock
of ``submit + run`` is purely our control plane's real CPU cost — then fits
(t_s, alpha_s) with the same ``fit_power_law`` used on the paper's data,
placing our virtual-clock engine on the paper's Figure-4 axes next to the
four measured systems.

Method notes:

* DT(n) is the min over ``--trials`` runs (min, not mean: scheduling noise
  is strictly additive, so the minimum is the best estimate of the true
  cost — standard micro-benchmark practice). Unlike the reference, the
  port takes the trials in turns across the sizes (trial 1 of every n,
  then trial 2, ...), after one untimed run at the smallest n: a host
  stall or a cold start then spoils one trial of a point, which the
  minimum discards, instead of every trial of one point (on the H100
  machine's host a cold start once put all three first-point trials 1.8x
  high and the wave fit at r2 0.966).
* Both dispatch paths are measured; ``wave`` is the headline fit (it is the
  engine's default), ``per_event`` quantifies what wave batching buys.
* A separate pass at the largest n runs under the ``obs.SelfProfiler`` to
  attribute the measured time to admission / cycle / dispatch / completion
  phases.  Separate on purpose: profiling overhead must not pollute the
  fitted points.
* ``--quick`` is the smoke: a tiny sweep plus a flight-recorder
  export round-trip (record -> export_chrome -> re-parse -> count/schema
  asserts); no artifact is written and no r2 gate applies.

A port of the reference's ``benchmarks/self_latency.py`` onto
``repro_torch`` (the reference's own run is committed as
``experiments/self_latency.json``). The artifact is written only to the
file ``--out`` names; the acceptance gate carries over: a wave-path fit
below r2 0.99 exits nonzero.

    PYTHONPATH=src python -m repro_torch.bench.self_latency --out sl.json
    PYTHONPATH=src python -m repro_torch.bench.self_latency --quick
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.core import (FAMILIES, Job, LatencyProfile, ResourceManager,
                              Scheduler, SchedulerConfig, fit_power_law)
from repro_torch.obs import FlightRecorder, SelfProfiler

P = 1408                      # the paper's cluster size
TRIALS = 3
#: job sizes swept (tasks per job); spans under- to over-subscribed at P
#: sweep floor sits above the fixed-overhead knee: at >= 1M tasks/s the
#: sub-millisecond small-n runs measure setup cost, not marginal latency,
#: and bend the power-law fit below its r2 gate
N_SWEEP = (4096, 8192, 16384, 32768, 65536, 131072, 262144)
#: quick sizes sit above the fixed-overhead knee (~1ms of setup swamps a
#: sub-millisecond run and drives the fitted alpha below the smoke's bound
#: now that the arena path clears 1M tasks/s)
N_QUICK = (1024, 4096, 16384)
#: many-jobs axis: job *counts* swept at a fixed small width — the Byun
#: et al. short-job regime where per-job overhead, not per-task overhead,
#: dominates.  DT is fitted over total tasks (jobs * width) so the fit
#: lands on the same Figure-4 axes as the single-array sweep.
J_WIDTH = 4
J_SWEEP = (512, 1024, 2048, 4096, 8192, 16384, 32768)
J_QUICK = (512, 2048, 8192)

#: all-zero cost model: virtual time contributes nothing, so wall-clock of
#: submit+run is purely the control plane's own (real) cost per task
ZERO = LatencyProfile(name="zero", central_cost=0.0, queue_coeff=0.0,
                      completion_cost=0.0, startup_cost=0.0,
                      cycle_interval=0.0, submit_cost=0.0)


def build(procs: int, wave: bool) -> Scheduler:
    rm = ResourceManager()
    rm.add_nodes(procs, slots=1)
    return Scheduler(rm, profile=ZERO,
                     config=SchedulerConfig(wave_batching=wave))


def measure_once(n: int, procs: int, wave: bool, *,
                 attach=None) -> Tuple[float, Scheduler]:
    """Wall-clock seconds to schedule one n-task unit job to completion."""
    s = build(procs, wave)
    if attach is not None:
        attach(s)
    job = Job.array(n, durations=[0.0] * n)   # pre-built: admission excluded
    t0 = time.perf_counter()
    s.submit(job)
    s.run()
    dt = time.perf_counter() - t0
    assert s.completed == n, (s.completed, n)
    return dt, s


def _in_turns(sizes, trials: int, once) -> List[float]:
    """min over ``trials`` of ``once(size)`` for each size, the trials
    taken in turns across the sizes after one untimed ``once(sizes[0])``."""
    once(sizes[0])
    best = [float("inf")] * len(sizes)
    for _ in range(trials):
        for i, size in enumerate(sizes):
            best[i] = min(best[i], once(size))
    return best


def sweep(sizes, procs: int, wave: bool, trials: int,
          verbose: bool = True) -> List[Tuple[int, float]]:
    pts = []
    best = _in_turns(sizes, trials,
                     lambda n: measure_once(n, procs, wave)[0])
    for n, dt in zip(sizes, best):
        pts.append((n, dt))
        if verbose:
            print(f"  n={n:>7}  DT={dt * 1e3:9.2f} ms  "
                  f"({dt / n * 1e6:6.2f} us/task)")
    return pts


def measure_jobs_once(jobs: int, width: int, procs: int,
                      arena: bool) -> Tuple[float, Scheduler]:
    """Wall-clock seconds to schedule ``jobs`` unit jobs of ``width`` tasks
    to completion (jobs pre-built: object construction excluded, admission
    of every job included — per-job overhead is the thing measured)."""
    rm = ResourceManager()
    rm.add_nodes(procs, slots=1)
    s = Scheduler(rm, profile=ZERO,
                  config=SchedulerConfig(wave_batching=True, arena=arena))
    js = [Job.array(width, duration=0.0) for _ in range(jobs)]
    t0 = time.perf_counter()
    for j in js:
        s.submit(j)
    s.run()
    dt = time.perf_counter() - t0
    assert s.completed == jobs * width, (s.completed, jobs, width)
    return dt, s


def sweep_jobs(counts, width: int, procs: int, arena: bool, trials: int,
               verbose: bool = True) -> List[Tuple[int, float]]:
    pts = []
    best = _in_turns(counts, trials, lambda jobs: measure_jobs_once(
        jobs, width, procs, arena)[0])
    for jobs, dt in zip(counts, best):
        n = jobs * width
        pts.append((n, dt))
        if verbose:
            print(f"  jobs={jobs:>6} (n={n:>7})  DT={dt * 1e3:9.2f} ms  "
                  f"({dt / n * 1e6:6.2f} us/task)")
    return pts


def fit_points(pts: List[Tuple[int, float]]) -> Dict:
    fit = fit_power_law([n for n, _ in pts], [dt for _, dt in pts])
    return {
        "t_s": fit.t_s, "alpha_s": fit.alpha_s, "r2": fit.r2,
        "points": [{"n": n, "dt_s": dt} for n, dt in pts],
    }


def profile_phases(n: int, procs: int, wave: bool) -> Dict:
    prof = SelfProfiler()      # stride=1: exact self times for attribution
    dt, _ = measure_once(n, procs, wave,
                         attach=lambda s: prof.attach(s))
    rep = prof.report()
    rep["_total"] = {"n": n, "wall_s": dt, "profiled_self_s": prof.total_s}
    return rep


def trace_roundtrip(tmpdir: Path, procs: int = 64, n: int = 500) -> Dict:
    """Record -> export_chrome -> re-parse -> count/schema asserts."""
    rec = FlightRecorder()
    measure_once(n, procs, True, attach=rec.attach)
    counts = rec.counts()
    assert counts["dispatch"] == n and counts["complete"] == n, counts
    assert counts["submit"] == 1 and counts["job_done"] == 1, counts
    path = tmpdir / "self_latency_trace.json"
    written = rec.export_chrome(str(path))
    assert written == len(rec.events), (written, len(rec.events))
    doc = json.loads(path.read_text())
    tev = doc["traceEvents"]
    spans = [e for e in tev if e.get("ph") == "X"]
    assert len(spans) == n, len(spans)
    assert all("pid" in e and "name" in e for e in tev)
    assert all("ts" in e for e in tev if e["ph"] != "M")
    assert {e["ph"] for e in tev} <= {"M", "X", "C", "i"}, \
        {e["ph"] for e in tev}
    path.unlink()
    return {"events": len(rec.events), "chrome_records": written,
            "spans": len(spans)}


def quick() -> Dict:
    """The smoke: a tiny sweep of both axes and the trace round-trip."""
    print("self-latency smoke (quick): tiny sweep at P=256")
    pts = sweep(N_QUICK, 256, True, 2)
    fit = fit_points(pts)
    print(f"  fit: t_s={fit['t_s']:.3g}s alpha_s={fit['alpha_s']:.3g} "
          f"r2={fit['r2']:.4f}")
    assert fit["t_s"] > 0.0 and 0.5 < fit["alpha_s"] < 2.0, fit
    print("  many-jobs axis (arena path):")
    mj_pts = sweep_jobs(J_QUICK, J_WIDTH, 256, True, 2)
    mj_fit = fit_points(mj_pts)
    print(f"  fit: t_s={mj_fit['t_s']:.3g}s "
          f"alpha_s={mj_fit['alpha_s']:.3g} r2={mj_fit['r2']:.4f}")
    assert mj_fit["t_s"] > 0.0 and 0.5 < mj_fit["alpha_s"] < 2.0, mj_fit
    with tempfile.TemporaryDirectory() as td:
        rt = trace_roundtrip(Path(td))
    print(f"  trace round-trip: {rt['events']} events -> "
          f"{rt['chrome_records']} chrome records "
          f"({rt['spans']} task spans) OK")
    print("self-latency smoke OK")
    return {"wave": fit, "many_jobs_arena": mj_fit, "trace": rt}


def run(procs: int = P, trials: int = TRIALS) -> Dict:
    """The full sweep: both dispatch paths, both many-jobs engines, the
    profiled pass at the largest n; the artifact's dict (``gate`` holds it
    to the acceptance gate)."""
    print(f"self-latency sweep: P={procs}, trials={trials}, "
          f"n in {list(N_SWEEP)}")
    print("wave path:")
    wave_pts = sweep(N_SWEEP, procs, True, trials)
    wave_fit = fit_points(wave_pts)
    print("per-event path:")
    evt_pts = sweep(N_SWEEP, procs, False, trials)
    evt_fit = fit_points(evt_pts)
    print(f"many-jobs axis (width {J_WIDTH}), arena path:")
    mj_pts = sweep_jobs(J_SWEEP, J_WIDTH, procs, True, trials)
    mj_fit = fit_points(mj_pts)
    print(f"many-jobs axis (width {J_WIDTH}), object path:")
    mjo_pts = sweep_jobs(J_SWEEP, J_WIDTH, procs, False, trials)
    mjo_fit = fit_points(mjo_pts)
    phases = profile_phases(N_SWEEP[-1], procs, True)

    paper = {name: {"t_s": prof.target_ts, "alpha_s": prof.target_alpha}
             for name, prof in FAMILIES.items() if prof.target_ts > 0.0}
    result = {
        "P": procs, "trials": trials,
        "method": "wall-clock of submit+run under an all-zero "
                  "LatencyProfile; DT(n) = min over trials; "
                  "fit_power_law on (n, DT)",
        "engine": {"wave": wave_fit, "per_event": evt_fit,
                   "many_jobs_arena": mj_fit,
                   "many_jobs_object": mjo_fit},
        "many_jobs_axis": {"width": J_WIDTH,
                           "job_counts": list(J_SWEEP),
                           "note": "DT over total tasks for jobs*width "
                                   "unit jobs; arena = struct-of-arrays "
                                   "span path, object = same "
                                   "engine with arena disabled"},
        "phases": phases,
        "paper_figure4_systems": paper,
    }
    for label, fit in (("wave", wave_fit), ("per_event", evt_fit),
                       ("mj_arena", mj_fit), ("mj_object", mjo_fit)):
        print(f"{label:>10}: t_s={fit['t_s']:.3g}s "
              f"alpha_s={fit['alpha_s']:.3g} r2={fit['r2']:.5f}")
    print("phase attribution at n=%d:" % N_SWEEP[-1])
    for phase, st in phases.items():
        if phase.startswith("_"):
            continue
        print(f"  {phase:>10}: {st['self_s'] * 1e3:8.2f} ms "
              f"({st['fraction']:6.1%}, {st['calls']} calls)")
    return result


def gate(result: Dict) -> None:
    """The acceptance gate: raises SystemExit when the wave-path fit of
    ``run``'s result misses r2 0.99."""
    r2 = result["engine"]["wave"]["r2"]
    if r2 < 0.99:
        raise SystemExit(f"wave-path fit r2={r2:.4f} < 0.99 — "
                         "measured points do not follow a power law; "
                         "rerun on a quiet machine or raise --trials")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--P", type=int, default=P, help="cluster slots")
    ap.add_argument("--trials", type=int, default=TRIALS,
                    help="runs per point; DT is the minimum")
    ap.add_argument("--out", type=Path,
                    help="write the JSON artifact here (by default nothing "
                         "is written)")
    ap.add_argument("--quick", action="store_true",
                    help="smoke: tiny sweep + trace-export round-trip, "
                         "no artifact, no r2 gate")
    args = ap.parse_args(argv)
    if args.quick:
        quick()
        return 0
    result = run(args.P, args.trials)
    gate(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1) + "\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

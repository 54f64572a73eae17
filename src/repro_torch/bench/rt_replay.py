"""rt-replay: measured *wall-clock* (t_s, alpha_s) of the async runtime.

``self_latency.py`` puts the virtual-clock engine on the paper's Figure-4
axes by timing the control plane's own CPU cost.  This benchmark measures
the full wall-clock control plane the paper actually timed: every task is
a claim/lease/result round-trip between the driver's ``AsyncRuntime`` and
real worker threads over a real transport (``repro_torch.rt``).  DT(n) —
submit to job retirement, zero-work payloads — is swept over job size n
and fitted with the same ``fit_power_law``:

* ``in_memory``  queue-pair transport: protocol + pump overhead only;
* ``socket``     loopback TCP with pickle framing: adds real kernel
                 round-trips — the closest analogue of the paper's
                 single-node scheduler measurements.

r2 is *reported, not gated*: wall-clock points on a shared machine carry
scheduling noise that no rerun policy can fully remove (the virtual-clock
benches keep the hard gates).

Flags:
  --quick           smoke: tiny in-memory sweep + a seeded chaos soak
                    (drop/dup/delay + worker kill/hang/restart) with
                    exactly-once-or-quarantined asserts; no artifact.
  --chaos           run the chaos soak in a full run too (recorded in the
                    artifact).
  --check-baseline  after the rt run, re-run the *virtual-clock* bench
                    smoke (sched_throughput --quick --check-baseline) to
                    confirm the simulation anchor is untouched by the rt
                    plane.

A port of the reference's ``benchmarks/rt_replay.py`` onto ``repro_torch``.
The artifact is written only to the file ``--out`` names. ``sweep`` and
``chaos_soak`` take the job to run (``make_job``, ``payload``), so callers
can lease real work (``chip_smoke.py`` leases tasks that run on the card).

    PYTHONPATH=src python -m repro_torch.bench.rt_replay --out rt.json
    PYTHONPATH=src python -m repro_torch.bench.rt_replay --quick \
        --check-baseline
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import Job, SchedulerConfig, WallFaultArm, fit_power_law
from repro_torch.core.job import TaskState
from repro_torch.obs import FlightRecorder
from repro_torch.rt import (AsyncRuntime, ChaosTransport, InMemoryTransport,
                            SocketTransport, WorkerPool)

WORKERS = 4
SLOTS = 8
TRIALS = 2
N_MEM = (64, 128, 256, 512, 1024, 2048)
N_SOCK = (32, 64, 128, 256, 512)
N_QUICK = (32, 64, 128)
POINT_TIMEOUT = 120.0


def _fleet(make_transport: Callable, *, workers: int = WORKERS,
           slots: int = SLOTS, **rt_kw):
    """Fresh (transport, runtime, pool) with every worker registered —
    setup is excluded from the timed window."""
    transport = make_transport()
    rt = AsyncRuntime(transport, address="127.0.0.1:0"
                      if isinstance(transport, SocketTransport)
                      else "driver", **rt_kw)
    pool = WorkerPool(transport, rt.address, workers,
                      slots=slots, hb_every=0.05).start()
    deadline = time.monotonic() + 10.0
    while rt.up_workers < workers:
        rt.step()
        if time.monotonic() > deadline:
            raise RuntimeError(f"only {rt.up_workers}/{workers} "
                               "workers registered")
        time.sleep(0.002)
    return transport, rt, pool


def measure_once(make_transport: Callable, n: int,
                 make_job: Callable[[int], Job] = Job.array,
                 attach: Optional[Callable] = None) -> float:
    """Wall seconds to drive one n-task job (``make_job(n)``; by default
    zero-work: zero duration -> SleepPayload(0)) to retirement.
    ``attach(rt)`` installs observers before the job is submitted."""
    _, rt, pool = _fleet(make_transport, lease_ttl=30.0,
                         heartbeat_interval=0.2, heartbeat_timeout=2.0)
    try:
        if attach is not None:
            attach(rt)
        job = make_job(n)
        t0 = time.perf_counter()
        rt.submit(job)
        ok = rt.run_until_idle(timeout=POINT_TIMEOUT)
        dt = time.perf_counter() - t0
        assert ok, f"n={n}: timed out after {POINT_TIMEOUT}s"
        assert rt.sch.completed == n, (rt.sch.completed, n)
        return dt
    finally:
        pool.stop()
        rt.close()


def sweep(label: str, make_transport: Callable, sizes,
          trials: int, make_job: Callable[[int], Job] = Job.array,
          check: Optional[Callable[[int], None]] = None) -> Dict:
    """DT(n) = min over ``trials`` runs for each n, and the fit;
    ``check(n)`` runs after each run (its outputs, say)."""
    pts: List[Tuple[int, float]] = []
    for n in sizes:
        dts = []
        for _ in range(trials):
            dts.append(measure_once(make_transport, n, make_job))
            if check is not None:
                check(n)
        dt = min(dts)
        pts.append((n, dt))
        print(f"  [{label}] n={n:>5}  DT={dt * 1e3:9.2f} ms  "
              f"({dt / n * 1e6:8.1f} us/task)")
    fit = fit_power_law([n for n, _ in pts], [dt for _, dt in pts])
    print(f"  [{label}] fit: t_s={fit.t_s:.3g}s alpha_s={fit.alpha_s:.3g} "
          f"r2={fit.r2:.4f}")
    return {"t_s": fit.t_s, "alpha_s": fit.alpha_s, "r2": fit.r2,
            "points": [{"n": n, "dt_s": dt} for n, dt in pts]}


# ------------------------------------------------------------- chaos soak
def chaos_soak(seed: int = 0, jobs: int = 2, tasks: int = 40,
               payload: Optional[Callable[[int, int], object]] = None,
               jobs_into: Optional[list] = None) -> Dict:
    """Seeded chaos: message drop/dup/delay + worker kill/hang/restart.

    Asserts the tentpole contract end-to-end: every task completes exactly
    once or is quarantined, no leases leak, and the FlightRecorder's
    lifecycle counts match the scheduler ledger. ``payload(job, task)``
    gives each task its payload (by default each sleeps 10 ms); the jobs
    run are appended to ``jobs_into``.
    """
    transport = ChaosTransport(InMemoryTransport(), drop=0.12, dup=0.08,
                               delay=0.01, seed=seed)
    rt = AsyncRuntime(transport, lease_ttl=0.3, heartbeat_interval=0.05,
                      heartbeat_timeout=0.25,
                      config=SchedulerConfig(retry_backoff=0.02,
                                             quarantine_after=8))
    rec = FlightRecorder().attach(rt.sch)
    pool = WorkerPool(transport, rt.address, 6, slots=2,
                      hb_every=0.02).start()
    arm = WallFaultArm(rt, pool, transport=transport, seed=seed)
    rec.attach_faults(arm)
    arm.schedule_random(1.0, kills=1, hangs=1, hang_len=0.4, restarts=1)
    if payload is None:
        batch = [Job.array(tasks, duration=0.01, max_restarts=100)
                 for _ in range(jobs)]
    else:
        batch = [Job.array(tasks, payloads=[payload(j, i)
                                            for i in range(tasks)],
                           max_restarts=100)
                 for j in range(jobs)]
    for job in batch:
        rt.submit(job)
    ok = rt.run_until_idle(timeout=90.0)
    pool.stop()
    rt.close()
    assert ok, f"chaos soak wedged: {rt.summary()}"
    done = {TaskState.COMPLETED, TaskState.QUARANTINED}
    for job in batch:
        for t in job.tasks:
            assert t.state in done, (t.key, t.state)
    assert not rt._leases, f"leaked leases: {list(rt._leases)}"
    counts = rec.counts()
    sch = rt.sch
    assert counts.get("complete", 0) == sch.completed
    assert counts.get("quarantine", 0) == sch.quarantined
    assert counts.get("requeue", 0) + counts.get("backoff", 0) \
        == sch.requeues
    assert counts.get("dispatch", 0) == sch.dispatched
    out = rt.summary()
    out["chaos_transport"] = dict(transport.stats)
    out["faults_fired"] = arm.summary()
    out["recorder_counts"] = counts
    if jobs_into is not None:
        jobs_into.extend(batch)
    print(f"  chaos soak: {sch.completed} completed, "
          f"{sch.quarantined} quarantined, {sch.requeues} requeues, "
          f"{out['results_stale']} stale results fenced, "
          f"faults={out['faults_fired']} OK")
    return out


def _settle(before: set, timeout: float = 5.0) -> None:
    """Wait, up to ``timeout`` seconds, for the threads started since
    ``before`` (worker slots, heartbeats, chaos delivery timers) to end."""
    end = time.monotonic() + timeout
    while time.monotonic() < end and any(
            t.ident not in before for t in threading.enumerate()):
        time.sleep(0.01)


def check_baseline() -> None:
    """Re-run the virtual-clock bench smoke against its committed anchor:
    the rt plane must not have moved the simulation's numbers."""
    from repro_torch.bench import sched_throughput
    print("virtual-clock anchor (sched_throughput --quick "
          "--check-baseline):")
    # raises SystemExit on a >3x regression; returns the result dict (the
    # port's driver writes no JSON without --out)
    result = sched_throughput.main(["--quick", "--suite", "fifo",
                                    "--check-baseline"])
    assert result, "virtual-clock baseline check returned nothing"
    print("  virtual-clock anchor OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trials", type=int, default=TRIALS)
    ap.add_argument("--out", type=Path,
                    help="write the JSON artifact here (by default nothing "
                         "is written)")
    ap.add_argument("--quick", action="store_true",
                    help="smoke: tiny in-memory sweep + chaos soak, "
                         "no artifact")
    ap.add_argument("--chaos", action="store_true",
                    help="include the chaos soak in a full run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-baseline", action="store_true",
                    help="also re-run the virtual-clock bench smoke "
                         "against its committed anchor")
    args = ap.parse_args(argv)
    # the anchor is timed on this process's wall clock: it runs once the
    # rt threads this run started have ended
    before = {t.ident for t in threading.enumerate()}

    if args.quick:
        print("rt-replay smoke (quick): in-memory sweep")
        fit = sweep("in_memory", InMemoryTransport, N_QUICK, 1)
        assert fit["t_s"] > 0.0, fit
        chaos_soak(seed=args.seed)
        if args.check_baseline:
            _settle(before)
            check_baseline()
        print("rt-replay smoke OK")
        return 0

    print(f"rt-replay sweep: {WORKERS} workers x {SLOTS} slots, "
          f"trials={args.trials}")
    print("in-memory transport:")
    mem_fit = sweep("in_memory", InMemoryTransport, N_MEM, args.trials)
    print("socket transport (loopback TCP):")
    sock_fit = sweep("socket", SocketTransport, N_SOCK, args.trials)
    result = {
        "method": "wall-clock submit->retirement of one n-task zero-work "
                  "job over a live worker fleet; DT(n) = min over trials; "
                  "fit_power_law on (n, DT); r2 reported, not gated "
                  "(wall noise)",
        "fleet": {"workers": WORKERS, "slots_per_worker": SLOTS},
        "trials": args.trials,
        "transports": {"in_memory": mem_fit, "socket": sock_fit},
    }
    if args.chaos:
        result["chaos_soak"] = chaos_soak(seed=args.seed)
    if args.check_baseline:
        _settle(before)
        check_baseline()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1) + "\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Scheduler-family latency profiles (paper §3.1, Table 10).

Each profile parameterizes the *mechanisms* that produce launch latency:

  central_cost     serial scheduler time per dispatch (resource selection,
                   allocation, RPC) — Slurm/GE's dominant term
  queue_coeff      extra serial time per dispatch proportional to the
                   pending-queue depth (queue scans/sorts) — produces the
                   super-linear exponent alpha_s > 1
  completion_cost  serial scheduler time per task completion (teardown,
                   accounting)
  startup_cost     node-local per-task launch overhead occupying the slot
                   (prolog, container/app-master start) — YARN's dominant
                   term (33 s marginal latency, alpha ~ 1)
  cycle_interval   scheduling-cycle coalescing interval

The paper's measured (t_s, alpha_s) for each scheduler are stored as
calibration targets; benchmarks fit the model to our simulated runs and
compare against these (Table 10 reproduction).

A copy of the reference's ``repro/core/families.py``; test files named
below are the reference's, and ``tests/test_torch_scheduler.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LatencyProfile:
    name: str
    central_cost: float = 0.0       # s per dispatch (serial)
    queue_coeff: float = 0.0        # s per dispatch per queued task (serial)
    completion_cost: float = 0.0    # s per completion (serial)
    startup_cost: float = 0.0       # s per task, node-local (parallel)
    cycle_interval: float = 0.05    # s between scheduling cycles
    submit_cost: float = 0.0        # s per job at submission
    # paper-measured targets (Table 10) for validation
    target_ts: float = 0.0
    target_alpha: float = 1.0


# Calibrated so that fitting Delta-T = t_s * n^alpha over the paper's grid
# (n in {4, 8, 48, 240}, P = 1408) reproduces Table 10 (see
# benchmarks/table10_model_fit.py for the fit and the comparison).
SLURM = LatencyProfile(
    name="slurm",
    central_cost=7.287e-3,
    queue_coeff=1.877e-8,
    completion_cost=2.0e-4,
    startup_cost=1.673,
    cycle_interval=0.05,
    target_ts=2.2, target_alpha=1.3,
)

GRID_ENGINE = LatencyProfile(
    name="grid_engine",
    central_cost=9.3e-3,
    queue_coeff=2.9e-8,
    completion_cost=2.5e-4,
    startup_cost=2.13,
    cycle_interval=0.1,
    target_ts=2.8, target_alpha=1.3,
)

MESOS = LatencyProfile(
    name="mesos",
    central_cost=3.0e-3,
    queue_coeff=8.0e-9,
    completion_cost=3.0e-4,
    startup_cost=2.8,
    cycle_interval=0.2,
    target_ts=3.4, target_alpha=1.1,
)

YARN = LatencyProfile(
    name="yarn",
    central_cost=1.2e-3,
    queue_coeff=0.0,
    completion_cost=5.0e-4,
    startup_cost=31.5,     # application-master launch per job (White 2015)
    cycle_interval=0.5,
    target_ts=33.0, target_alpha=1.0,
)

# An idealized profile for the framework's own control plane (eager dispatch):
# costs are milliseconds, not seconds — used by the real-dispatch benchmarks.
INPROC = LatencyProfile(
    name="inproc",
    central_cost=2e-5,
    completion_cost=1e-5,
    startup_cost=2e-4,
    cycle_interval=0.001,
)

FAMILIES = {p.name: p for p in (SLURM, GRID_ENGINE, MESOS, YARN, INPROC)}

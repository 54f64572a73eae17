"""Shared benchmark machinery: the paper's Table-9 experiment grid, on the
port's scheduler core.

Task sets (Table 9): t in {1, 5, 30, 60}s with T_job fixed at 240 s per
processor (n = 240/t), P = 1408 single-slot nodes. Each (scheduler, set) is
run `trials` times; the figure drivers share one simulation pass through
an in-process table of rows.

All runs flow through the workload subsystem (``repro_torch.workloads``):
the task set is a spec stream fed by the StreamingInjector. The paper grid
streams a single job array; scaled grids (P >= 100k, n up to 240, tens of
millions of tasks) stream per-wave arrays of P tasks under an active-job
cap so peak materialized state stays O(P · window) instead of O(n · P).

The committed artifacts under ``experiments/`` (the reference's runs of
the same grids) are read, never written: ``all_results`` holds every row
it computes that the committed ``bench_cache.json`` also holds equal to it
bit for bit, and keeps its rows in this process only.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.core import FAMILIES, ResourceManager, Scheduler, aggregate
from repro_torch.core.multilevel import MultilevelConfig
from repro_torch.workloads import (MetricsTap, StreamingInjector,
                                   constant_taskset)

P = 1408
TASK_SETS: Tuple[Tuple[str, float, int], ...] = (
    # (name, task time t, tasks/processor n)
    ("rapid", 1.0, 240),
    ("fast", 5.0, 48),
    ("medium", 30.0, 8),
    ("long", 60.0, 4),
)
SCHEDULERS = ("slurm", "grid_engine", "mesos", "yarn")
TRIALS = int(os.environ.get("BENCH_TRIALS", "3"))
ROOT = Path(__file__).resolve().parents[3]
EXPERIMENTS = ROOT / "experiments"
CACHE = EXPERIMENTS / "bench_cache.json"

# scaled-grid streaming defaults: waves of P tasks, at most 8 jobs in flight
STREAM_ACTIVE_JOBS = 8

# rows computed in this process, by cache key: the figure drivers reuse
# one pass of the grid (the engine is deterministic, so a row never goes
# stale)
_ROWS: Dict[str, Dict] = {}


def run_taskset(family: str, n: int, t: float, multilevel: bool = False,
                seed: int = 0, processors: int = P,
                wave_tasks: int = 0, max_active_jobs: int = 0,
                tap: Optional[MetricsTap] = None,
                attach=None) -> Dict:
    """One Table-9 run; returns T_total, Delta-T and utilization.

    ``processors`` scales the paper's grid beyond its P=1408 (the 100k-slot
    runs fit (t_s, alpha_s) at P >= 100,000).  ``wave_tasks``/
    ``max_active_jobs`` stream the set in bounded waves (see module
    docstring); 0/0 reproduces the paper's single-array submission exactly.
    ``attach`` (a callable taking the Scheduler) installs extra observers
    before any job is submitted; pure observation, so the row must
    reproduce the committed cache exactly.
    """
    prof = FAMILIES[family]
    rm = ResourceManager()
    rm.add_nodes(processors, slots=1)
    s = Scheduler(rm, profile=prof)
    if attach is not None:
        attach(s)
    transform = None
    if multilevel:
        transform = lambda job: aggregate(  # noqa: E731
            job, slots=processors, cfg=MultilevelConfig(mode="mimo"))
    source = constant_taskset(t, n, processors, wave_tasks=wave_tasks,
                              name=f"{family}-{n}-{t}")
    inj = StreamingInjector(s, source, max_active_jobs=max_active_jobs,
                            transform=transform, tap=tap)
    inj.run()
    assert inj.drained, "task set did not drain"
    sts = list(s.stats.values())
    T_total = (max(st.last_end for st in sts)
               - min(st.submit_time for st in sts))
    T_job = t * n               # isolated per-processor work (original tasks)
    out = {
        "family": family, "n": n, "t": t, "multilevel": multilevel,
        "P": processors,
        "T_total": T_total, "T_job": T_job, "delta_t": T_total - T_job,
        "utilization": T_job / T_total,
    }
    if wave_tasks or max_active_jobs:
        out["stream"] = {"wave_tasks": wave_tasks,
                         "max_active_jobs": max_active_jobs,
                         "jobs": inj.submitted_jobs,
                         "tasks": inj.submitted_tasks,
                         "peak_active_jobs": inj.peak_active_jobs}
    return out


def load_grid_artifact(processors: int) -> Dict:
    """The committed streamed-grid artifact for P processors (fig4/fig5
    scaled views render from it instead of re-running the grid)."""
    path = EXPERIMENTS / f"table9_grid_P{processors}.json"
    if not path.exists():
        raise SystemExit(
            f"{path} missing — run: python -m "
            f"repro_torch.bench.table9_tasksets --P {processors} --grid "
            "--out PATH, and render from PATH")
    return json.loads(path.read_text())


def without_wall(obj):
    """``obj`` after a JSON round trip (tuples become lists, as in a
    committed artifact) with every host-clock field dropped: what two runs
    of the virtual-time engine must agree on bit for bit."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k not in ("wall_s", "tasks_per_s")}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return strip(json.loads(json.dumps(obj)))


def _key(family, n, t, multilevel, trial):
    return f"{family}|{n}|{t}|{int(multilevel)}|{trial}"


def load_committed_cache() -> Dict:
    """The reference's committed Table-9 rows (trial 0, direct)."""
    return json.loads(CACHE.read_text())


def check_committed(key: str, row: Dict, committed: Dict) -> None:
    """Raise unless ``row`` equals the committed row under ``key`` (when
    there is one) in every field."""
    want = committed.get(key)
    if want is not None and without_wall(row) != without_wall(want):
        raise SystemExit(
            f"row {key} diverged from the committed {CACHE.name}: "
            f"{row} != {want} — virtual time is bit-reproducible, so the "
            "accounting changed")


def all_results(multilevel: bool = False, trials: int = TRIALS,
                schedulers=SCHEDULERS) -> List[Dict]:
    """Full grid. Skips YARN rapid (paper: 'exceedingly long') in
    non-multilevel mode, exactly as Table 9 does. Every row the committed
    ``bench_cache.json`` holds must come out equal to it."""
    committed = load_committed_cache()
    out = []
    for fam in schedulers:
        for name, t, n in TASK_SETS:
            if fam == "yarn" and name == "rapid" and not multilevel:
                continue   # Table 9 footnote: not executed
            for trial in range(trials):
                k = _key(fam, n, t, multilevel, trial)
                if k not in _ROWS:
                    # trial index varies the seed only; the engine is
                    # deterministic, so re-trials confirm determinism
                    _ROWS[k] = run_taskset(fam, n, t, multilevel,
                                           seed=trial)
                    check_committed(k, _ROWS[k], committed)
                r = dict(_ROWS[k])
                r["trial"] = trial
                r["set"] = name
                out.append(r)
    return out

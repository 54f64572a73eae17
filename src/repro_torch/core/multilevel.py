"""Multilevel scheduling — LLMapReduce (paper §5.3, Byun et al. 2016).

Transparently aggregates many short tasks into one scheduler-visible job per
processor (or per bundle), cutting Delta-T 30-100x and restoring >90%
utilization for 1-second tasks.

Two aggregation modes, as in LLMapReduce:
  * siso  — the map application restarts per input (single-input/single-
            output): each bundled task still pays a per-task app-startup
            overhead inside the bundle, but *not* the scheduler dispatch.
  * mimo  — the (mildly modified) map application starts once and streams
            many input/output pairs: per-task overhead is just I/O.

The same abstraction serves PyTorch: bundling k short dispatches
(inference requests, eval shards) into one batched call is exactly mimo-mode
multilevel scheduling — the serving engine builds on this module.

A copy of the reference's ``repro/core/multilevel.py``; test files named
below are the reference's, and ``tests/test_torch_multilevel.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from repro_torch.core.job import Job, ResourceRequest, Task


@dataclass(frozen=True)
class MultilevelConfig:
    mode: str = "mimo"             # siso | mimo
    app_startup: float = 0.2       # s, one-time map-app start per bundle
    per_task_overhead_siso: float = 0.2   # s, app restart per input (siso)
    per_task_overhead_mimo: float = 0.005  # s, I/O per input (mimo)
    bundles_per_slot: int = 1      # bundles per processor slot


def bundle_durations(task_durations: Sequence[float],
                     cfg: MultilevelConfig) -> float:
    per = (cfg.per_task_overhead_siso if cfg.mode == "siso"
           else cfg.per_task_overhead_mimo)
    return cfg.app_startup + sum(task_durations) + per * len(task_durations)


def aggregate(job: Job, slots: int,
              cfg: Optional[MultilevelConfig] = None) -> Job:
    """Rewrite a job array of N short tasks into <= slots bundled mappers.

    The bundled job is what actually hits the scheduler; per-bundle duration
    models the map application processing its slice of inputs sequentially.
    Payloads (real mode) are composed into one callable per bundle.
    """
    cfg = cfg or MultilevelConfig()
    n_bundles = min(slots * cfg.bundles_per_slot, job.n_tasks) or 1
    per_bundle = math.ceil(job.n_tasks / n_bundles)
    durations: List[float] = []
    payloads: List[Optional[Callable]] = []
    for b in range(n_bundles):
        chunk = job.tasks[b * per_bundle:(b + 1) * per_bundle]
        if not chunk:
            break
        durations.append(bundle_durations([t.duration for t in chunk], cfg))
        calls = [t.payload for t in chunk if t.payload is not None]
        payloads.append(_compose(calls) if calls else None)
    bundled = Job.array(
        len(durations), durations=durations,
        payloads=payloads if any(p is not None for p in payloads) else None,
        request=job.tasks[0].request if job.tasks else ResourceRequest(),
        name=f"{job.name}-mlsched", user=job.user, queue=job.queue,
        priority=job.priority)
    bundled.max_restarts = job.max_restarts
    return bundled


def map_reduce(n_tasks: int, task_duration: float, slots: int,
               reduce_duration: float = 0.0,
               cfg: Optional[MultilevelConfig] = None,
               payloads: Optional[Sequence[Callable]] = None,
               reduce_payload: Optional[Callable] = None,
               **job_kw) -> List[Job]:
    """Full LLMapReduce pattern: bundled mappers + a dependent reducer job.

    Returns [mapper_job, reducer_job] with a DAG dependency; submit both.
    """
    raw = Job.array(n_tasks, task_duration, payloads=payloads,
                    name=job_kw.pop("name", "map"), **job_kw)
    mappers = aggregate(raw, slots, cfg)
    out = [mappers]
    if reduce_duration > 0 or reduce_payload is not None:
        reducer = Job.array(1, reduce_duration,
                            payloads=[reduce_payload] if reduce_payload else None,
                            name=f"{mappers.name}-reduce")
        reducer.depends_on = (mappers.job_id,)
        out.append(reducer)
    return out


def _compose(calls: Sequence[Callable]) -> Callable:
    def bundle_payload():
        results = [c() for c in calls]
        return results
    return bundle_payload


def true_task_seconds(job: Job) -> float:
    """Isolated task time of the *original* workload represented by a
    bundled job (excludes aggregation overheads) — the T_job numerator when
    computing utilization honestly for multilevel runs."""
    return sum(t.duration for t in job.tasks)

"""Workload specs: lightweight, lazily-materialized job descriptions.

A workload source is any iterator of :class:`JobSpec` in nondecreasing
arrival order.  A spec is a few scalars — the heavyweight ``Job``/``Task``
objects are only built by the streaming injector at the spec's arrival time,
which is what lets an n-million-task trace run in O(active) memory.

DAG edges are expressed *relative to the stream* (``depends_on_prev``):
"this job depends on the job built k specs ago".  The injector resolves the
offsets against a bounded ring of recently-built job ids, so dependency
resolution is O(window), never O(history) — a trace can carry an unbounded
chain of map→reduce stages without the id map growing with it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.job import Job, ResourceRequest

#: Largest backward stream offset a spec may depend on (ring-buffer size).
MAX_DEP_WINDOW = 1024


@dataclass
class JobSpec:
    """One job arrival: everything needed to build a ``Job``, nothing more."""

    arrival: float = 0.0
    n_tasks: int = 1
    duration: float = 0.0                        # per-task virtual runtime
    durations: Optional[Sequence[float]] = None  # per-task override
    request: Optional[ResourceRequest] = None    # shared across tasks
    name: str = "job"
    user: str = "user"
    queue: str = "default"
    priority: float = 0.0
    parallel: bool = False                       # gang: all tasks co-start
    depends_on_prev: Tuple[int, ...] = ()        # stream offsets, e.g. (1,)
    max_restarts: int = 0
    failure_policy: str = "retry"                # retry|fail_fast|best_effort
    meta: Dict[str, object] = field(default_factory=dict)

    def build(self, depends_on: Tuple[int, ...] = ()) -> Job:
        """Materialize the Job (the only place Task objects are created)."""
        job = Job.array(
            self.n_tasks, self.duration, durations=self.durations,
            request=self.request, name=self.name, user=self.user,
            queue=self.queue, priority=self.priority,
            depends_on=depends_on)
        job.parallel = self.parallel
        job.max_restarts = self.max_restarts
        job.failure_policy = self.failure_policy
        return job


def validate_stream(specs: Iterable[JobSpec]) -> Iterator[JobSpec]:
    """Pass-through guard: arrival monotonicity + dependency window bounds.

    Wrap an untrusted source (e.g. a hand-edited trace) before injection;
    generator families in this package are monotone by construction and skip
    the check.
    """
    last = float("-inf")
    for i, spec in enumerate(specs):
        if spec.arrival < last:
            raise ValueError(
                f"spec {i} ({spec.name!r}) arrives at {spec.arrival} after "
                f"{last}: workload sources must be time-ordered")
        for off in spec.depends_on_prev:
            if not 0 < off <= MAX_DEP_WINDOW:
                raise ValueError(
                    f"spec {i} ({spec.name!r}) depends on offset {off}; "
                    f"offsets must be in [1, {MAX_DEP_WINDOW}]")
            if off > i:
                raise ValueError(
                    f"spec {i} ({spec.name!r}) depends on offset {off} "
                    "before the start of the stream")
        last = spec.arrival
        yield spec


def materialize(specs: Iterable[JobSpec]) -> List[Job]:
    """Eagerly build every job (tests / tiny traces only — defeats the
    streaming injector's O(active) memory bound on purpose)."""
    jobs: List[Job] = []
    for spec in specs:
        deps = tuple(jobs[-off].job_id for off in spec.depends_on_prev)
        jobs.append(spec.build(depends_on=deps))
    return jobs

"""Job / task data structures: lifecycle states, resource requests, DAGs.

Follows the paper's functional model (§1): jobs enter via the user interface,
are queued by job-lifecycle management, matched to resources by the
scheduling function, and dispatched by the job-execution function. A Job is
either a single task, a *job array* (independent tasks under one id — the
paper's measurements submit arrays because they "introduce much less
scheduler latency than individual jobs"), or a *parallel* job (gang: all
tasks must co-start — the SPMD/TPU case).

A copy of the reference's ``repro/core/job.py``; test files named
below are the reference's, and ``tests/test_torch_scheduler.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class JobState(enum.Enum):
    PENDING = "pending"        # submitted, not yet eligible (deps unmet)
    QUEUED = "queued"          # eligible, waiting for resources
    RUNNING = "running"        # >=1 task dispatched
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


class TaskState(enum.Enum):
    WAITING = "waiting"
    DISPATCHED = "dispatched"  # scheduler has committed resources
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    PREEMPTED = "preempted"
    CANCELLED = "cancelled"
    BACKOFF = "backoff"        # failed; re-eligible after a virtual-time delay
    QUARANTINED = "quarantined"  # poison task: repeated fault-coincident deaths


@dataclass(slots=True)
class ResourceRequest:
    """Per-task resource request (static + consumable resources, §3.2.4)."""

    slots: int = 1                 # cpu cores / job slots
    mem_mb: int = 0
    accelerators: int = 0          # GPUs/TPU chips on the node
    licenses: Tuple[str, ...] = ()
    node_attrs: Dict[str, Any] = field(default_factory=dict)  # constraints


# the no-constraint unit request every defaulted Job.array shares: requests
# are read-only in the engine, and one shared instance keeps array
# construction off the allocator on the million-job submit path (the
# scheduler's unit check also collapses to an identity test against it)
_DEFAULT_REQ = ResourceRequest()


# lifecycle fields a fresh Task leaves unset until the engine first writes
# them (construction is on the submit hot path at millions of tasks; five
# untouched slot stores per task are measurable)
_TASK_LAZY = {
    "node_id": None,
    "submit_time": 0.0,
    "dispatch_time": 0.0,
    "start_time": 0.0,
    "end_time": 0.0,
    "fault_hits": 0,           # attempts lost to node deaths (quarantine)
    "backoff_until": 0.0,      # requeue-eligibility time (retry backoff)
}


@dataclass(slots=True, init=False)
class Task:
    job_id: int
    index: int
    duration: float = 0.0              # simulated runtime (virtual seconds)
    payload: Optional[Callable] = None  # real work (executor-dependent)
    request: ResourceRequest = field(default_factory=ResourceRequest)
    state: TaskState = TaskState.WAITING
    node_id: Optional[int] = None
    submit_time: float = 0.0
    dispatch_time: float = 0.0     # resources committed
    start_time: float = 0.0        # began executing
    end_time: float = 0.0
    attempts: int = 0
    speculative_of: Optional[int] = None  # straggler-mitigation clone
    fault_hits: int = 0
    backoff_until: float = 0.0

    def __init__(self, job_id: int, index: int, duration: float = 0.0,
                 payload: Optional[Callable] = None,
                 request: Optional[ResourceRequest] = None,
                 state: TaskState = TaskState.WAITING,
                 node_id: Optional[int] = None, submit_time: float = 0.0,
                 dispatch_time: float = 0.0, start_time: float = 0.0,
                 end_time: float = 0.0, attempts: int = 0,
                 speculative_of: Optional[int] = None):
        self.job_id = job_id
        self.index = index
        self.duration = duration
        self.payload = payload
        self.request = ResourceRequest() if request is None else request
        self.state = state
        self.attempts = attempts
        self.speculative_of = speculative_of
        # lifecycle fields stay unset (see _TASK_LAZY / __getattr__) unless
        # a non-default value is passed explicitly
        if node_id is not None:
            self.node_id = node_id
        if submit_time:
            self.submit_time = submit_time
        if dispatch_time:
            self.dispatch_time = dispatch_time
        if start_time:
            self.start_time = start_time
        if end_time:
            self.end_time = end_time

    def __getattr__(self, name):
        # only reached on unset slots: lazy lifecycle defaults
        try:
            return _TASK_LAZY[name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def key(self) -> Tuple[int, int]:
        return (self.job_id, self.index)


_job_ids = itertools.count(1)


# rarely-touched Job fields left unset until first written (construction is
# on the million-job submit path; the engine-hot fields — the submit gate's
# reads and the arena burst's — are stored eagerly in __init__)
_JOB_LAZY = {
    "name": "job",
    "user": "user",
    "submit_time": 0.0,
    "end_time": 0.0,
    "failed_tasks": 0,
    "n_clones": 0,
    "max_restarts": 0,
    "failure_policy": "retry",
    "_arena": None,
    "_filled": 0,
}


@dataclass(slots=True, init=False)
class Job:
    """A job: one task, an array of independent tasks, or a gang-parallel job.

    Task materialization is *lazy*: ``Job.array`` records a compact spec
    (``_lazy``) instead of building Task objects, and the ``tasks`` property
    builds them on first access — either fresh (unscheduled jobs, the
    object-path engine) or as views over the scheduler's struct-of-arrays
    arena (``core/arena.py``) when the job was dispatched through the arena
    fast lane.  Hot-path consumers (``n_tasks``, the injector, job
    retirement) never materialize.
    """

    name: str = "job"
    user: str = "user"
    queue: str = "default"
    priority: float = 0.0
    parallel: bool = False            # gang: all tasks co-scheduled
    _tasks: Optional[List[Task]] = None
    depends_on: Tuple[int, ...] = ()  # job ids (DAG dependencies, §3.2.3)
    state: JobState = JobState.PENDING
    submit_time: float = 0.0
    end_time: float = 0.0
    job_id: int = field(default_factory=lambda: next(_job_ids))
    # bookkeeping
    completed_tasks: int = 0
    failed_tasks: int = 0
    n_clones: int = 0                 # speculative clones appended to tasks
    max_restarts: int = 0             # per-task restart budget (§3.2.7)
    # what a permanent task failure means for the rest of the job:
    #   "retry"       — siblings keep running; job FAILED at the end (default)
    #   "fail_fast"   — cancel every non-terminal sibling, retire FAILED now
    #   "best_effort" — job retires COMPLETED if any task completed
    failure_policy: str = "retry"
    # lazy-materialization spec: (n, duration, durations-tuple|None, request)
    _lazy: Optional[Tuple[int, float, Optional[Tuple[float, ...]],
                          ResourceRequest]] = None
    _arena: Optional[Any] = None      # Arena owning this job's task slab
    _lo: int = -1                     # first arena task id (contiguous range)
    _filled: int = 0                  # arena tasks dispatched so far

    def __init__(self, name: str = "job", user: str = "user",
                 queue: str = "default", priority: float = 0.0,
                 parallel: bool = False,
                 _tasks: Optional[List[Task]] = None,
                 depends_on: Tuple[int, ...] = (),
                 state: JobState = JobState.PENDING,
                 submit_time: float = 0.0, end_time: float = 0.0,
                 job_id: Optional[int] = None, completed_tasks: int = 0,
                 failed_tasks: int = 0, n_clones: int = 0,
                 max_restarts: int = 0, failure_policy: str = "retry"):
        self.queue = queue
        self.priority = priority
        self.parallel = parallel
        self._tasks = _tasks
        self.depends_on = depends_on
        self.state = state
        self.job_id = next(_job_ids) if job_id is None else job_id
        self.completed_tasks = completed_tasks
        self._lazy = None
        self._lo = -1
        # everything below stays unset unless non-default (see _JOB_LAZY /
        # __getattr__)
        if name != "job":
            self.name = name
        if user != "user":
            self.user = user
        if submit_time:
            self.submit_time = submit_time
        if end_time:
            self.end_time = end_time
        if failed_tasks:
            self.failed_tasks = failed_tasks
        if n_clones:
            self.n_clones = n_clones
        if max_restarts:
            self.max_restarts = max_restarts
        if failure_policy != "retry":
            self.failure_policy = failure_policy

    def __getattr__(self, name):
        # only reached on unset slots: lazy field defaults
        try:
            return _JOB_LAZY[name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def tasks(self) -> List[Task]:
        t = self._tasks
        if t is None:
            t = self._materialize()
        return t

    @tasks.setter
    def tasks(self, value: List[Task]) -> None:
        self._tasks = value

    def _materialize(self) -> List[Task]:
        if self._arena is not None:
            self._arena.materialize_job(self)
            return self._tasks
        spec = self._lazy
        if spec is None:
            self._tasks = []
            return self._tasks
        n, duration, durations, req = spec
        jid = self.job_id
        if durations is None:
            ts = [Task(jid, i, duration, None, req) for i in range(n)]
        else:
            ts = [Task(jid, i, durations[i], None, req) for i in range(n)]
        st = self.submit_time
        if st:
            for t in ts:
                t.submit_time = st
        self._tasks = ts
        return ts

    @classmethod
    def array(cls, n_tasks: int, duration: float = 0.0, *,
              payloads: Optional[Sequence[Callable]] = None,
              request: Optional[ResourceRequest] = None,
              durations: Optional[Sequence[float]] = None,
              **kw) -> "Job":
        """A job array of n independent tasks.

        All tasks share one request object (requests are read-only in the
        engine): array construction stays O(n) small allocations and the
        scheduler's unit-job check collapses to identity comparisons.
        Without payloads the build is deferred entirely — only the spec is
        stored, and Task objects exist when something reads ``job.tasks``.
        """
        job = cls(**kw) if kw else cls()
        req = request or _DEFAULT_REQ
        if payloads is None:
            job._lazy = (n_tasks, duration,
                         tuple(durations) if durations is not None else None,
                         req)
            return job
        jid = job.job_id
        job._tasks = [
            Task(jid, i,
                 durations[i] if durations is not None else duration,
                 payloads[i], req)
            for i in range(n_tasks)]
        return job

    @classmethod
    def parallel_job(cls, n_tasks: int, duration: float = 0.0, *,
                     request: Optional[ResourceRequest] = None, **kw) -> "Job":
        job = cls.array(n_tasks, duration, request=request, **kw)
        job.parallel = True
        return job

    @property
    def n_tasks(self) -> int:
        # never materializes: retirement/injector accounting reads this on
        # the hot path where Task objects may not (and must not) exist
        t = self._tasks
        if t is not None:
            return len(t)
        spec = self._lazy
        return spec[0] if spec is not None else 0

    @property
    def n_real_tasks(self) -> int:
        """Tasks excluding speculative clones (a clone resolves its
        original's slot in the completion accounting)."""
        return self.n_tasks - self.n_clones

    @property
    def done(self) -> bool:
        return self.completed_tasks + self.failed_tasks >= self.n_real_tasks

    def pending_tasks(self) -> List[Task]:
        return [t for t in self.tasks
                if t.state in (TaskState.WAITING, TaskState.PREEMPTED)]


@dataclass(slots=True)
class JobStats:
    """Per-job accounting recorded by job-lifecycle management."""

    job_id: int = 0
    submit_time: float = 0.0
    first_dispatch: float = 0.0
    last_end: float = 0.0
    task_seconds: float = 0.0      # Σ isolated task runtimes (T_job numerator)
    n_tasks: int = 0

    @property
    def total_time(self) -> float:
        return self.last_end - self.submit_time

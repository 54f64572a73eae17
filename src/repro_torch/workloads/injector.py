"""Streaming injector: feed a workload source into the virtual-clock engine.

The injector holds exactly one spec of lookahead: the next arrival is an
event on the scheduler's ``EventLoop``, and handling it builds the Job (the
first time any Task object for it exists), submits it, and schedules the
following arrival.  Job/Task graphs are O(active jobs), never O(trace
length) — the property that lets n reach millions of tasks (acceptance:
peak materialized jobs stays O(P) on a 1M-task run).  What *is* retained
per job ever submitted is scalar metadata only: a ``JobStats`` record (the
benchmarks' T_total/utilization accounting) and the QueueManager's terminal
state id — tens of bytes each, no task references.

Backpressure: with ``max_active_jobs`` set, the injector stops pulling the
source while that many jobs are in flight and resumes from the scheduler's
``on_job_done`` hook — admission control in front of the scheduler, the same
throttle a site RM applies to a misbehaving submit loop.  It also registers
as an EventLoop arrival source (``add_source``), so even a source whose next
arrival is only computable lazily keeps the loop alive without pre-pushed
events.
"""
from __future__ import annotations

import collections
from typing import Callable, Deque, Iterable, Iterator, List, Optional

from repro_torch.core.job import Job
from repro_torch.core.scheduler import Scheduler
from repro_torch.workloads.metrics import MetricsTap
from repro_torch.workloads.spec import MAX_DEP_WINDOW, JobSpec


class StreamingInjector:
    def __init__(self, scheduler: Scheduler, source: Iterable[JobSpec], *,
                 max_active_jobs: int = 0,
                 transform: Optional[Callable[[Job], object]] = None,
                 tap: Optional[MetricsTap] = None,
                 dep_window: int = MAX_DEP_WINDOW):
        """``transform`` may rewrite a built Job before submission (e.g.
        multilevel ``aggregate``) and may return a Job or a list of Jobs
        (e.g. ``map_reduce`` bundles); dependency offsets resolve against
        the *last* job a spec produced.  The ring covers every offset
        ``validate_stream`` admits by default; shrinking ``dep_window``
        below a stream's largest offset is an error at arrival time, never
        a silently dropped edge."""
        self.sch = scheduler
        self._it: Iterator[JobSpec] = iter(source)
        self.max_active_jobs = max_active_jobs
        self.transform = transform
        self.tap = tap.attach(scheduler) if tap is not None else None
        self._recent: Deque[int] = collections.deque(
            maxlen=min(max(dep_window, 1), MAX_DEP_WINDOW))
        self._next: Optional[JobSpec] = None
        self._deferred = False         # backpressure holding the stream
        self._exhausted = False
        # counters (the memory-bound acceptance reads peak_active_jobs)
        self.submitted_jobs = 0
        self.submitted_tasks = 0
        self.peak_active_jobs = 0
        # chain behind any tap already hooked on on_job_done
        self._chain_done = scheduler.on_job_done
        scheduler.on_job_done = self._on_job_done
        scheduler.loop.add_source(self._refill)
        self._pull()
        self._schedule_next()

    # --------------------------------------------------------- plumbing
    def _pull(self) -> None:
        try:
            self._next = next(self._it)
        except StopIteration:
            self._next = None
            self._exhausted = True

    def _schedule_next(self) -> None:
        """Push the single lookahead arrival onto the loop, unless the
        active-job cap says to hold the stream."""
        if self._next is None:
            return
        if (self.max_active_jobs
                and self.sch.active_jobs >= self.max_active_jobs):
            self._deferred = True
            return
        self._deferred = False
        spec, self._next = self._next, None
        self.sch.loop.at(spec.arrival, self._arrive, spec)

    def _refill(self) -> bool:
        """EventLoop drain hook: lazily produce the next arrival event."""
        if self._next is None and not self._exhausted:
            self._pull()
        if self._next is not None and not self._deferred:
            self._schedule_next()
            return True
        return False

    # ---------------------------------------------------------- arrival
    def _arrive(self, spec: JobSpec) -> None:
        loop = self.sch.loop
        while True:
            deps = []
            for off in spec.depends_on_prev:
                if not 0 < off <= len(self._recent):
                    raise ValueError(
                        f"spec {spec.name!r} depends on stream offset {off}; "
                        "offsets are positive and must fall inside the "
                        f"injector's {self._recent.maxlen}-job dependency "
                        "window (raise dep_window)")
                deps.append(self._recent[-off])
            job = spec.build(depends_on=tuple(deps))
            jobs: List[Job]
            if self.transform is not None:
                out = self.transform(job)
                jobs = list(out) if isinstance(out, (list, tuple)) else [out]
            else:
                jobs = [job]
            for j in jobs:
                self.sch.submit(j)
                self.submitted_jobs += 1
                self.submitted_tasks += j.n_tasks
            # the spec's dependency anchor is the last job it produced
            self._recent.append(jobs[-1].job_id)
            if self.sch.active_jobs > self.peak_active_jobs:
                self.peak_active_jobs = self.sch.active_jobs
            self._pull()
            # coalesce a run of same-instant arrivals into this callback —
            # one heap event per burst, not per job.  Only when the burst is
            # up next anyway: a due arrival would otherwise be (re)pushed at
            # (now, fresh-seq), i.e. run after every already-queued event at
            # ``now``, so it may only be inlined if no such event is pending
            # and the active-job cap would not defer it.
            nxt = self._next
            if (nxt is None or nxt.arrival > loop.now
                    or (self.max_active_jobs
                        and self.sch.active_jobs >= self.max_active_jobs)):
                break
            top = loop.peek()
            if top is not None and top[0] <= loop.now:
                break
            spec = nxt
            self._next = None
        self._schedule_next()

    def _on_job_done(self, job: Job) -> None:
        if self._deferred:
            self._schedule_next()
        if self._chain_done is not None:
            self._chain_done(job)

    # -------------------------------------------------------------- run
    @property
    def drained(self) -> bool:
        """Source exhausted and every injected job retired."""
        return (self._exhausted and self._next is None
                and self.sch.active_jobs == 0)

    def run(self, until: float = float("inf")) -> None:
        """Drive the scheduler until the stream drains (or ``until``)."""
        self.sch.run(until)

    def close(self) -> None:
        self.sch.loop.remove_source(self._refill)

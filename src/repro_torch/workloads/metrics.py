"""Metrics tap: per-dispatch latency, queue depth, utilization time series.

One tap serves every benchmark: it attaches to the scheduler's observation
hooks (``on_dispatch`` / ``on_job_done``) and keeps bounded state however
long the run is — scalar accumulators, a fixed-size reservoir for latency
percentiles, and a stride-doubling time series (when the buffer fills, every
other point is dropped and the sampling stride doubles), so a 100M-dispatch
run costs the same memory as a 10k one.

The tap is a thin view over a :class:`repro_torch.obs.registry.Registry`: its
instruments (dispatch counter, latency histogram, depth/utilization/requeue
series) live in the registry under ``tap.*`` names, where dashboards and
snapshots can read them alongside engine gauges; the tap's historical
attributes (``dispatches``, ``latency_sum``, ``depth_series``...) are reads
of those same instruments, and ``summary()`` is schema-stable
byte-for-byte.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from repro_torch.core.job import Job, Task
from repro_torch.core.scheduler import Scheduler


class Reservoir:
    """Vitter's algorithm R over a float stream; exact below ``size``.

    The sorted view is computed on the first ``percentile`` call and cached
    until the next ``add`` — ``summary()`` reads three percentiles, one
    sort.
    """

    def __init__(self, size: int = 4096, seed: int = 0):
        self.size = size
        self.seen = 0
        self._rng = random.Random(seed)
        self._buf: List[float] = []
        self._sorted: Optional[List[float]] = None

    def add(self, x: float) -> None:
        self.seen += 1
        if len(self._buf) < self.size:
            self._buf.append(x)
            self._sorted = None
        else:
            j = self._rng.randrange(self.seen)
            if j < self.size:
                self._buf[j] = x
                self._sorted = None

    def percentile(self, q: float) -> float:
        if not self._buf:
            return 0.0
        s = self._sorted
        if s is None:
            s = self._sorted = sorted(self._buf)
        idx = min(int(q / 100.0 * len(s)), len(s) - 1)
        return s[idx]


class TimeSeries:
    """(t, value) series with a hard point cap via stride doubling."""

    def __init__(self, max_points: int = 2048):
        self.max_points = max_points
        self.stride = 1
        self._count = 0
        self.points: List[Tuple[float, float]] = []

    def add(self, t: float, v: float) -> None:
        self._count += 1
        if self._count % self.stride:
            return
        self.points.append((t, v))
        if len(self.points) >= self.max_points:
            self.points = self.points[::2]
            self.stride *= 2


class MetricsTap:
    """Attach to a Scheduler; read summary() at the end of the run.

    Dispatch latency is the paper's quantity: scheduler-time at resource
    commitment minus task submit time (virtual seconds).  Queue depth and
    slot utilization are sampled on every dispatch/retire event through the
    stride-doubling series.

    ``attach`` raises if the tap is already attached (re-attaching would
    self-chain the hooks into an infinite replay); ``detach`` restores the
    exact hook chain that ``attach`` found, provided the tap is still the
    outermost subscriber on each hook it owns.
    """

    def __init__(self, *, reservoir: int = 4096, max_points: int = 2048,
                 registry=None):
        # local import keeps the package import graph acyclic (obs.registry
        # lazily reuses Reservoir/TimeSeries from this module)
        from repro_torch.obs.registry import Registry
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        self._disp = r.counter("tap.dispatches")
        self._done = r.counter("tap.jobs_done")
        self._rq = r.counter("tap.requeues")
        self._lat = r.histogram("tap.dispatch_latency_s", size=reservoir)
        self.depth_series = r.series("tap.queue_depth", max_points)
        self.util_series = r.series("tap.utilization", max_points)
        self.requeue_series = r.series("tap.requeue_count", max_points)
        self.lost_work_series = r.series("tap.lost_work_s", max_points)
        self._sch: Optional[Scheduler] = None
        self._chain_dispatch = None
        self._chain_dispatch_batch = None
        self._chain_done = None
        self._chain_requeue = None
        self._bound_dispatch = None
        self._bound_batch = None
        self._bound_done = None
        self._bound_requeue = None

    # ------------------------------------------------- legacy attributes
    # (thin-view reads of the registry instruments; the public API and
    # every historical consumer keep working unchanged)
    @property
    def dispatches(self) -> int:
        return self._disp.value

    @property
    def jobs_done(self) -> int:
        return self._done.value

    @property
    def requeues(self) -> int:
        return self._rq.value

    @property
    def latency_sum(self) -> float:
        return self._lat.sum

    @property
    def latency_max(self) -> float:
        return self._lat.max

    # ---------------------------------------------------- attach/detach
    def attach(self, sch: Scheduler) -> "MetricsTap":
        if self._sch is not None:
            raise RuntimeError(
                "MetricsTap is already attached; call detach() first "
                "(re-attaching would self-chain its hooks)")
        self._sch = sch
        self._chain_dispatch = sch.on_dispatch
        self._chain_dispatch_batch = sch.on_dispatch_batch
        self._chain_done = sch.on_job_done
        # keep the exact bound-method objects installed on the scheduler:
        # the batch hook compares identity against them to notice when a
        # later subscriber clobbered the per-task hook (see
        # _on_dispatch_batch)
        self._bound_dispatch = self._on_dispatch
        self._bound_batch = self._on_dispatch_batch
        self._bound_done = self._on_job_done
        self._bound_requeue = self._on_requeue
        sch.on_dispatch = self._bound_dispatch
        sch.on_dispatch_batch = self._bound_batch
        sch.on_job_done = self._bound_done
        self._chain_requeue = sch.on_requeue
        sch.on_requeue = self._bound_requeue
        return self

    def detach(self) -> "MetricsTap":
        """Restore the exact prior hook chain and release the scheduler.

        Only the *outermost* subscriber can detach: if a later observer
        chained (or clobbered) on top of this tap, popping the tap out of
        the middle would orphan it, so ``detach`` raises instead.
        """
        sch = self._sch
        if sch is None:
            return self
        installed = (
            ("on_dispatch", self._bound_dispatch, self._chain_dispatch),
            ("on_dispatch_batch", self._bound_batch,
             self._chain_dispatch_batch),
            ("on_job_done", self._bound_done, self._chain_done),
            ("on_requeue", self._bound_requeue, self._chain_requeue),
        )
        for attr, ours, _ in installed:
            if getattr(sch, attr) is not ours:
                raise RuntimeError(
                    f"cannot detach: a later subscriber replaced {attr}; "
                    "detach observers outermost-first")
        for attr, _, prior in installed:
            setattr(sch, attr, prior)
        self._sch = None
        self._chain_dispatch = self._chain_dispatch_batch = None
        self._chain_done = self._chain_requeue = None
        self._bound_dispatch = self._bound_batch = None
        self._bound_done = self._bound_requeue = None
        return self

    # ------------------------------------------------------------ hooks
    def _on_dispatch(self, task: Task, queue_depth: int) -> None:
        sch = self._sch
        lat = max(task.dispatch_time - task.submit_time, 0.0)
        self._disp.value += 1
        self._lat.add(lat)
        now = sch.loop.now
        self.depth_series.add(now, float(queue_depth))
        total = sch.rm.total_slots()
        if total:
            self.util_series.add(
                now, 1.0 - sch.rm.free_slots() / total)
        if self._chain_dispatch is not None:
            self._chain_dispatch(task, queue_depth)

    def _on_dispatch_batch(self, tasks: List[Task],
                           depths: List[int]) -> None:
        """Wave-path observer: one call per dispatch wave.

        Records exactly what per-task ``_on_dispatch`` calls would have: the
        wave is unit-slot and bulk-allocated, so the free-slot count the
        i-th per-event dispatch would have observed is the post-wave count
        plus the slots the rest of the wave had not yet taken.
        """
        sch = self._sch
        now = sch.loop.now
        total = sch.rm.total_slots()
        free_end = sch.rm.free_slots()
        m = len(tasks)
        # per-task adds (not a local partial sum) keep the histogram's
        # float accumulation bit-identical to per-event observation
        lat_add = self._lat.add
        depth_add = self.depth_series.add
        util_add = self.util_series.add
        for i, task in enumerate(tasks):
            lat = max(task.dispatch_time - task.submit_time, 0.0)
            lat_add(lat)
            depth_add(now, float(depths[i]))
            if total:
                util_add(now, 1.0 - (free_end + (m - 1 - i)) / total)
        self._disp.value += m
        # per-task replay: attaching the tap put the engine on the wave
        # path, which never calls on_dispatch — so per-task subscribers
        # must be replayed here or they silently observe nothing.
        if self._chain_dispatch_batch is not None:
            self._chain_dispatch_batch(tasks, depths)
            replay = None                   # inner tap replays its own chain
        else:
            replay = self._chain_dispatch   # subscriber attached before us
        cur = sch.on_dispatch
        if (sch.on_dispatch_batch is self._bound_batch
                and cur is not None and cur is not self._bound_dispatch):
            # a subscriber attached *after* us clobbered our per-task hook;
            # per-event semantics would fire only it (the clobbered chain
            # below it is dead), so replay to it instead
            replay = cur
        if replay is not None:
            for i, task in enumerate(tasks):
                replay(task, depths[i])

    def _on_job_done(self, job: Job) -> None:
        self._done.value += 1
        if self._chain_done is not None:
            self._chain_done(job)

    def _on_requeue(self, task: Task, now: float) -> None:
        """Fault-lifecycle hook: fires once per requeue decision (immediate
        or backoff), never on the no-fault hot path."""
        self._rq.value += 1
        self.requeue_series.add(now, float(self._rq.value))
        self.lost_work_series.add(now, self._sch.lost_work_s)
        if self._chain_requeue is not None:
            self._chain_requeue(task, now)

    # ---------------------------------------------------------- summary
    def summary(self) -> Dict:
        n = max(self.dispatches, 1)
        return {
            "dispatches": self.dispatches,
            "jobs_done": self.jobs_done,
            "dispatch_latency_mean_s": self.latency_sum / n,
            "dispatch_latency_p50_s": self._lat.percentile(50),
            "dispatch_latency_p99_s": self._lat.percentile(99),
            "dispatch_latency_max_s": self.latency_max,
            # full stride-doubled series (bounded by max_points): the whole
            # run's shape, not a tail slice
            "queue_depth_series": list(self.depth_series.points),
            "utilization_series": list(self.util_series.points),
            **self._fault_summary(),
        }

    def _fault_summary(self) -> Dict:
        """Failure/recovery quantities (all zero on a no-fault run).

        ``goodput_fraction`` is completed task-seconds over completed plus
        discarded (lost-work) task-seconds — the goodput-vs-throughput
        split: occupancy the workload kept vs. occupancy that churn threw
        away.  Scheduler counters are authoritative; the series here are
        the tap's bounded-sampled views of them over virtual time.
        """
        sch = self._sch
        if sch is None:
            return {}
        goodput = sum(st.task_seconds for st in sch.stats.values())
        lost = sch.lost_work_s
        denom = goodput + lost
        return {
            "requeues": sch.requeues,
            "quarantined": sch.quarantined,
            "lost_work_s": lost,
            "goodput_task_seconds": goodput,
            "goodput_fraction": goodput / denom if denom > 0.0 else 1.0,
            "requeue_series": list(self.requeue_series.points),
            "lost_work_series": list(self.lost_work_series.points),
        }

"""The scheduler engine: the paper's four functions wired together.

  job lifecycle management  -> QueueManager (+ JobStats accounting)
  resource management       -> ResourceManager (heartbeats, allocation)
  scheduling                -> Policy (FIFO/backfill/binpack/locality, gang)
  job execution             -> dispatch/startup/teardown with a serialized
                               scheduler-time model (LatencyProfile)

Latency model mechanics: the scheduler is a *serial server* — every dispatch
consumes ``central_cost + queue_coeff * queue_depth`` seconds of scheduler
time and every completion ``completion_cost``; a dispatched task additionally
pays ``startup_cost`` node-locally before its payload runs. These mechanisms
generate the paper's Delta-T = t_s * n^alpha_s behaviour (families.py holds
per-family calibrations; benchmarks fit t_s and alpha_s from runs).

Hot-path accounting (control-plane scalability): the engine itself must not
become the bottleneck it models.  The task fetch walks the QueueManager's
dispatch-order heap (amortized O(1)); the queue depth the latency model
charges is an incrementally-maintained counter (updated on submit / cursor
advance / requeue / job finish) instead of an O(active-jobs) rescan per
dispatch; running tasks are indexed so straggler detection and node-failure
recovery scan only what is actually running.

The engine is used three ways:
  * virtual-time simulation (paper benchmark, scale experiments);
  * real-time with an Executor running Python/PyTorch payloads;
  * embedded as the control plane of the serving engine (serving/engine.py).

A copy of the reference's ``repro/core/scheduler.py``; test files named
below are the reference's, and ``tests/test_torch_scheduler.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

import bisect
import collections
import heapq
import statistics
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as _np                    # closed-form wave math, the arena

from repro_torch.core.arena import Arena, CHUNK_BITS as _CHUNK_BITS
from repro_torch.core.families import INPROC, LatencyProfile
from repro_torch.core.job import (Job, JobState, JobStats, Task, TaskState,
                            _DEFAULT_REQ)
from repro_torch.core.policies import FIFOPolicy, Policy
from repro_torch.core.queues import QueueManager
from repro_torch.core.resources import NodeState, ResourceManager
from repro_torch.core.simulator import EventLoop


@dataclass
class SchedulerConfig:
    speculative: bool = False          # straggler mitigation (clone slow tasks)
    speculative_factor: float = 2.0    # clone when runtime > factor * median
    preemption: bool = False
    # heartbeat-driven failure detection: > 0 schedules periodic
    # ``ResourceManager.sweep_heartbeats`` sweeps on the event loop, so a
    # silent node death is detected after a measurable virtual-time lag
    # (heartbeat_timeout .. + interval) and live nodes beat on task
    # completions.  0 keeps the legacy escape hatch: no sweeps, failures
    # only become visible through explicit ``mark_down``/``check_heartbeats``
    # calls by the driver (tests, the fault plane's announced failures).
    heartbeat_interval: float = 0.0
    # retry lifecycle: a failed/orphaned attempt with remaining budget is
    # requeued after ``retry_backoff * 2^(attempts-1)`` virtual seconds
    # (capped), instead of instantly; 0 preserves instant requeue.
    retry_backoff: float = 0.0
    retry_backoff_cap: float = 300.0
    # poison-task quarantine: a task whose attempts coincide with this many
    # node deaths is QUARANTINED (counts as a permanent failure) instead of
    # being requeued forever; 0 disables.
    quarantine_after: int = 0
    max_dispatch_per_cycle: int = 0    # 0 = unlimited
    # wave batching: dispatch whole free-capacity waves with a closed-form
    # serial-clock recurrence and coalesced completion batches.  Observably
    # identical to the per-event path (tests/test_wavepath.py); turn off to
    # force per-event processing (differential testing, debugging)
    wave_batching: bool = True
    # struct-of-arrays arena (core/arena.py): while the engine is in the
    # pure FIFO/unit regime with no observers and no fault machinery, jobs
    # bypass the QueueManager entirely (a FIFO deque of *lazy* jobs — no
    # Task objects) and dispatch/completion run over numpy slabs.  The span
    # is exited — flushing slabs and materializing Task views — the moment
    # anything object-observing appears, so behaviour stays bit-identical
    # to the object path (tests/test_arena.py pins it differentially).
    # Turn off to force the object path everywhere.
    arena: bool = True
    # recycle retired jobs' slab chunks (bounded-memory streaming): a job
    # materialized after its chunk was recycled raises instead of lying
    arena_recycle: bool = False


def _unit_request(r) -> bool:
    return not (r.slots != 1 or r.node_attrs or r.licenses
                or r.mem_mb or r.accelerators)


def _is_unit(job: Job) -> bool:
    """Eligible for the unit-slot fast path (one slot, no constraints).

    Checks every task, not just the first: a heterogeneous job must take the
    policy path. Job.array shares one request object across tasks, so the
    common case is O(n) identity comparisons, one real check.
    """
    if job.parallel:
        return False
    if not job.tasks:
        return True
    first = job.tasks[0].request
    if not _unit_request(first):
        return False
    for t in job.tasks:
        if t.request is not first and not _unit_request(t.request):
            return False
    return True


class _Wave:
    """A dispatched wave's coalesced completion batch.

    Parallel lists sorted by end time; ``pos`` is the drain cursor and
    ``seq`` the event-loop tie-break sequence reserved at dispatch time
    (shared by all members — per-event completion events would have held
    consecutive sequences with nothing in between, so one number preserves
    every ordering comparison against foreign events).
    """

    __slots__ = ("tasks", "ends", "atts", "keys", "nodes", "pos", "seq")

    def __init__(self, tasks: List[Task], ends: List[float], atts: List[int],
                 keys: List[Tuple[int, int]], nodes: List, seq: int):
        self.tasks = tasks
        self.ends = ends
        self.atts = atts
        self.keys = keys        # per-task (job_id, index), from allocation
        self.nodes = nodes      # per-task Node objects, from allocation
        self.pos = 0
        self.seq = seq


class _ArenaWave:
    """An arena-span dispatch wave: slab-backed, no Task objects.

    Mirrors ``_Wave`` member for member but holds numpy arrays and (job,
    run) descriptors instead of per-task objects.  ``clocks``/``ends_d``/
    ``nids_d`` are in dispatch order (they become the slab writes at wave
    retirement); ``ends``/``nids`` are in end order (the drain's bisect
    bound and bulk free-slot release).  For ascending waves the two orders
    coincide and the arrays are shared.  A span exit converts the wave into
    a ``_Wave`` over materialized views (``converted``) and the pending
    heap event — which kept its reserved ``seq`` — delegates to it.
    """

    __slots__ = ("runs", "clocks", "ends_d", "nids_d", "ends", "nids",
                 "order", "mem_jobs", "mem_durs", "pos", "ri", "seq",
                 "converted")

    def __init__(self):
        self.runs = None        # [(job, mstart, count, off0)] dispatch order
        self.clocks = None      # f8, dispatch order
        self.ends_d = None      # f8, dispatch order
        self.nids_d = None      # i32, dispatch order
        self.ends = None        # python list, end order (bisect)
        self.nids = None        # i32, end order (free-stack release)
        self.order = None       # end idx -> dispatch idx (None if ascending)
        self.mem_jobs = None    # per-member job, end order (non-asc drain)
        self.mem_durs = None    # per-member duration, end order (non-asc)
        self.pos = 0            # drain cursor (end order)
        self.ri = 0             # current run index (ascending drain)
        self.seq = 0            # reserved event-loop tie-break sequence
        self.converted = None   # _Wave after span exit


class Scheduler:
    def __init__(self, rm: ResourceManager, policy: Optional[Policy] = None,
                 profile: LatencyProfile = INPROC,
                 loop: Optional[EventLoop] = None,
                 executor: Optional["Executor"] = None,
                 config: Optional[SchedulerConfig] = None):
        self.rm = rm
        self.qm = QueueManager()
        self.policy = policy or FIFOPolicy()
        self.profile = profile
        self.loop = loop or EventLoop()
        self.executor = executor
        self.config = config or SchedulerConfig()
        self.stats: Dict[int, JobStats] = {}
        self.sched_clock = 0.0           # serial scheduler busy-until
        self.dispatched = 0
        self.completed = 0
        # fault-lifecycle counters (workloads/metrics.py reads these)
        self.requeues = 0                # attempts returned to the queue
        self.lost_work_s = 0.0           # virtual seconds of discarded work
        self.quarantined = 0             # poison tasks taken out of rotation
        self._sweep_armed = False        # heartbeat sweep scheduled on loop
        self._cursor: Dict[int, int] = {}          # job_id -> next task index
        self._requeue: Deque[Task] = collections.deque()
        self._free_stack: List = []      # fast path: free unit slots, as
        # Node objects (one entry per spare slot) — entries are validated
        # lazily against live node state, never eagerly maintained
        self._fast = isinstance(self.policy, FIFOPolicy)
        self._next_cycle: Optional[float] = None
        self._active_jobs: Dict[int, Job] = {}
        self._clones: Dict[Tuple[int, int], Task] = {}
        self._durations: Deque[float] = collections.deque(maxlen=512)
        # straggler-threshold cache: the median over _durations is
        # recomputed only when the deque changed since the last check
        # (satellite of the wave path: _speculate ran statistics.median —
        # O(window log window) — every cycle even when nothing completed)
        self._dur_version = 0            # bumped on every _durations append
        self._med_version = -1
        self._med_value = 0.0
        # incremental hot-path accounting
        self._depth = 0                  # == seed's recomputed _queue_depth()
        self._nonunit = 0                # active jobs ineligible for fast path
        self._unit: Dict[int, bool] = {}
        self._running_tasks: Dict[Tuple[int, int], Task] = {}
        # policy-path accounting: WAITING/PREEMPTED tasks of eligible jobs
        # (== the seed's per-cycle sum(len(j.pending_tasks())) rescan), plus
        # the zero-slot subset (they can place on slot-saturated nodes, so
        # they gate the policies' exhausted-capacity early exit)
        self._pending = 0
        self._pending_zero = 0
        self._job_pending: Dict[int, int] = {}
        # observation hooks (workload injector / metrics tap): None-checked on
        # the hot path so unobserved runs pay one comparison per event
        self.on_dispatch: Optional[Callable[[Task, int], None]] = None
        # batched observer for dispatch waves: called once per wave with
        # (tasks, queue_depths) after every task's bookkeeping is complete.
        # A subscriber that sets only on_dispatch forces the engine off the
        # wave path (the per-task hook observes mid-wave resource state that
        # a bulk-allocated wave no longer exposes); MetricsTap sets both.
        self.on_dispatch_batch: Optional[
            Callable[[List[Task], List[int]], None]] = None
        self.on_job_done: Optional[Callable[[Job], None]] = None
        self.on_submit: Optional[Callable[[Job], None]] = None
        self.on_requeue: Optional[Callable[[Task, float], None]] = None
        # observability-plane hooks (the reference's repro/obs/): task completion
        # (fires per task on both dispatch paths, in per-event order),
        # scheduling-cycle entry, poison-task quarantine, job eligibility
        # (enqueue at submit / dependency release), and heartbeat sweeps.
        # All None-checked like the hooks above: an unobserved run pays one
        # comparison per event and nothing else.
        self.on_complete: Optional[Callable[[Task, bool], None]] = None
        self.on_cycle: Optional[Callable[[float, int], None]] = None
        self.on_quarantine: Optional[Callable[[Task, float], None]] = None
        self.on_job_ready: Optional[Callable[[Job], None]] = None
        self.on_sweep: Optional[Callable[[float, List[int]], None]] = None
        # ------- struct-of-arrays arena fast lane (core/arena.py) -------
        # jobs on the lane live in _arena_q (a FIFO deque of lazy jobs,
        # bypassing the QueueManager) and, while the *span* is active,
        # dispatch/completion run over numpy slabs with the free-capacity
        # stack as an int32 node-id array.  Any observer, fault event, or
        # non-eligible job exits the span first (_exit_span), restoring
        # the object path mid-run with identical semantics.
        self._span = False
        self._arena_q: Deque[Job] = collections.deque()
        self._arena_jobs: Set[int] = set()
        self._arena_waves: Set[_ArenaWave] = set()
        self._arena_off = 0              # head-of-queue partial-fetch offset
        self._fs = None                  # int32 free-slot stack (span mode)
        self._fs_top = 0
        if (self.config.arena and self._fast
                and executor is None):
            self._arena = Arena(profile.startup_cost,
                                self.config.arena_recycle)
            self._arena._sch = self
            # node-state mutations (death, drain, rejoin, slow, growth)
            # must see flushed object state *before* they start
            rm.on_pre_change(self._exit_span)
            # a drained heap with arena residue still owes an exit (e.g.
            # run() returning mid-span must leave consistent object state)
            self.loop.add_source(self._arena_source)
        else:
            self._arena = None
        self.rm.on_node_down(self._node_down)
        self.rm.on_node_up(self._node_up)
        # executors that marshal completions through a thread-safe queue
        # (core/executor.py) drain it on this loop: completions become
        # events, serialized with every other engine state change
        if executor is not None and hasattr(executor, "bind_loop"):
            executor.bind_loop(self.loop)

    # ----------------------------------------------------------- submit
    def submit(self, job: Job) -> None:
        now = self.loop.now
        sc = self.sched_clock
        self.sched_clock = (sc if sc > now else now) + self.profile.submit_cost
        if self._arena is not None:
            spec = job._lazy
            if (spec is not None and job._tasks is None and spec[0] > 0
                    and not job.depends_on and job.priority == 0.0
                    and job.queue == "default" and not job.parallel
                    and len(self._active_jobs) == len(self._arena_jobs)
                    and (spec[3] is _DEFAULT_REQ or _unit_request(spec[3]))
                    and (c := self.config).wave_batching
                    and not c.speculative
                    and c.heartbeat_interval == 0.0
                    and self.on_dispatch is None
                    and self.on_dispatch_batch is None
                    and self.on_complete is None):
                # arena-lane admission, inline: scalar bookkeeping only —
                # no Task objects, no QueueManager registration
                # (``_exit_span`` adopts any still-queued lane job back
                # into it).  Field for field the same admission state the
                # object path leaves, minus the per-task walk (tasks are
                # all WAITING/unit by construction) and the ``_cursor``/
                # ``_unit`` entries (their reads default correctly).
                jid = job.job_id
                job.submit_time = now
                job.state = JobState.QUEUED
                self._arena_q.append(job)
                self._arena_jobs.add(jid)
                self._active_jobs[jid] = job
                n = spec[0]
                self._depth += n
                self._pending += n
                self._job_pending[jid] = n
                self.stats[jid] = JobStats(job_id=jid, submit_time=now,
                                           n_tasks=n)
                # inlined _request_cycle (same dedup, minus call + max())
                sc = self.sched_clock
                t = (now if now > sc else sc) + self.profile.cycle_interval
                nc = self._next_cycle
                if nc is None or nc > t:
                    self._next_cycle = t
                    self.loop.at(t, self._cycle)
                if self.on_submit is not None:
                    self.on_submit(job)
                if self.on_job_ready is not None:
                    self.on_job_ready(job)   # eligible at submit (no deps)
                return
            if self._span or self._arena_q or self._arena_waves:
                # a non-eligible job must never interleave with the lane:
                # flush it back into the QueueManager first (FIFO-safe:
                # lane jobs all predate this submit)
                self._exit_span()
        # one fused admission walk: per-task submit-time stamping (on
        # behalf of qm.submit), the unit-job check (_is_unit), and the
        # policy pending counts (_count_in) — identical results, one pass
        tasks = job.tasks
        jid = job.job_id
        n = z = 0
        if tasks:
            first = tasks[0].request
            unit = not job.parallel and _unit_request(first)
            WAITING = TaskState.WAITING
            PREEMPTED = TaskState.PREEMPTED
            for t in tasks:
                t.submit_time = now
                r = t.request
                if unit and r is not first and not _unit_request(r):
                    unit = False
                ts = t.state
                if ts is WAITING or ts is PREEMPTED:
                    n += 1
                    if r.slots <= 0:
                        z += 1
        else:
            unit = not job.parallel
        self.qm.submit(job, now, stamp_tasks=False)
        self._active_jobs[jid] = job
        self._cursor[jid] = 0
        self._unit[jid] = unit
        if not unit:
            self._nonunit += 1
        if job.state is not JobState.PENDING:     # eligible now -> counted
            self._depth += len(tasks)
            self._pending += n
            self._pending_zero += z
            self._job_pending[jid] = n
        self.stats[jid] = JobStats(
            job_id=jid, submit_time=now, n_tasks=len(tasks))
        self._request_cycle()
        if self.config.heartbeat_interval > 0.0 and not self._sweep_armed:
            self._sweep_armed = True
            self.loop.at(now + self.config.heartbeat_interval,
                         self._heartbeat_sweep)
        if self.on_submit is not None:
            self.on_submit(job)
        if self.on_job_ready is not None and job.state is not JobState.PENDING:
            self.on_job_ready(job)     # eligible at submit (no unmet deps)

    # ------------------------------------------------ pending accounting
    def _count_in(self, job: Job) -> None:
        """Add a newly-eligible job's pending tasks to the policy counters."""
        n = z = 0
        for t in job.tasks:
            if t.state in (TaskState.WAITING, TaskState.PREEMPTED):
                n += 1
                if t.request.slots <= 0:
                    z += 1
        self._pending += n
        self._pending_zero += z
        self._job_pending[job.job_id] = n

    def _count_out(self, job: Job) -> None:
        """Drop a retiring job's remaining pending tasks from the counters."""
        n = self._job_pending.pop(job.job_id, 0)
        if n == 0:
            return      # no pending tasks -> no pending zero-slot tasks
        self._pending -= n
        for t in job.tasks:
            if (t.state in (TaskState.WAITING, TaskState.PREEMPTED)
                    and t.request.slots <= 0):
                self._pending_zero -= 1

    def _count_requeued(self, task: Task) -> None:
        self._pending += 1
        if task.request.slots <= 0:
            self._pending_zero += 1
        self._job_pending[task.job_id] = \
            self._job_pending.get(task.job_id, 0) + 1

    # ----------------------------------------------------------- cycles
    def _request_cycle(self) -> None:
        t = max(self.loop.now, self.sched_clock) + self.profile.cycle_interval
        if self._next_cycle is not None and self._next_cycle <= t:
            return
        self._next_cycle = t
        self.loop.at(t, self._cycle)

    def _cycle(self) -> None:
        self._next_cycle = None
        if self.on_cycle is not None:
            self.on_cycle(self.loop.now, self._depth)
        if self._fast and self._all_unit():
            if self._span:
                if self._span_ok():
                    self._cycle_arena()
                else:
                    self._exit_span()
                    self._cycle_fast()
            elif self._arena_q:
                if (self._span_ok() and not self._running_tasks
                        and not self._requeue and self._enter_span()):
                    self._cycle_arena()
                else:
                    self._exit_span()
                    self._cycle_fast()
            else:
                self._cycle_fast()
        else:
            if self._span or self._arena_q or self._arena_waves:
                self._exit_span()
            self._cycle_policy()
        if self.config.speculative:
            self._speculate()
            # periodic re-check while work is in flight (stragglers reveal
            # themselves over time, not at completion events)
            if self._active_jobs:
                self.loop.after(max(self.profile.cycle_interval, 1.0),
                                self._maybe_recheck)

    def _maybe_recheck(self) -> None:
        if self._active_jobs and self._next_cycle is None:
            self._cycle()

    def _all_unit(self) -> bool:
        return self._nonunit == 0

    def _rebuild_free_stack(self) -> None:
        self._free_stack = []
        for n in self.rm.free_nodes():
            self._free_stack.extend([n] * n.free_slots)

    def _pop_free_node(self) -> Optional[int]:
        """Pop a validated unit-slot node, discarding stale stack entries."""
        while self._free_stack:
            node = self._free_stack.pop()
            if node.state is NodeState.UP and node.free_slots > 0:
                return node.node_id
        return None

    def _next_waiting(self) -> Optional[Task]:
        while self._requeue:
            t = self._requeue.popleft()
            self._depth -= 1
            # skip ghosts: a job can retire (e.g. its speculative clone
            # finished) while a failed original still sits here WAITING —
            # dispatching it would run work for a finished job and corrupt
            # the pending counters
            if (t.state in (TaskState.WAITING, TaskState.PREEMPTED)
                    and t.job_id in self._active_jobs):
                return t
        while True:
            job = self.qm.next_eligible()
            if job is None:
                return None
            cur = self._cursor.get(job.job_id, 0)
            n = job.n_tasks
            found: Optional[Task] = None
            while cur < n:
                t = job.tasks[cur]
                cur += 1
                self._depth -= 1
                if t.state is TaskState.WAITING:
                    found = t
                    break
            self._cursor[job.job_id] = cur
            if found is not None:
                return found
            self.qm.mark_exhausted(job.job_id)   # requeues bypass this path

    def _queue_depth(self) -> int:
        return self._depth

    def _cycle_fast(self) -> None:
        if not self._free_stack:
            self._rebuild_free_stack()
        if (self.config.wave_batching and self.executor is None
                and not self.config.speculative
                and (self.on_dispatch is None
                     or self.on_dispatch_batch is not None)):
            self._cycle_wave()
            return
        limit = self.config.max_dispatch_per_cycle or float("inf")
        count = 0
        while self._free_stack and count < limit:
            # validate the node *before* consuming a task so a stale stack
            # entry (node since drained/failed/filled) never drops a task
            node = self._free_stack[-1]
            if node.state is not NodeState.UP or node.free_slots <= 0:
                self._free_stack.pop()
                continue
            task = self._next_waiting()
            if task is None:
                break
            self._free_stack.pop()
            # fetching the task already decremented _depth; the latency model
            # charges the depth *including* the task being dispatched
            self._dispatch(task, node.node_id, self._depth + 1)
            count += 1

    # ------------------------------------------------- wave-batched path
    # In the FIFO/unit regime every dispatch of a cycle happens at the same
    # virtual instant and differs only in its serial-clock charge, and every
    # completion is a pure function of (start, duration) until some other
    # event intervenes.  The wave path exploits both: it takes the whole
    # free-capacity wave in one bulk fetch + bulk allocation, computes the
    # serial-clock recurrence  sched_clock += central_cost + queue_coeff *
    # depth  for the entire wave as a prefix sum (numpy above _WAVE_NUMPY),
    # and schedules ONE coalesced completion event per wave that finishes
    # members in end-time order, yielding to the event heap whenever a real
    # event (cycle, arrival, another wave's batch) would interleave.  The
    # engine falls back to the per-event path whenever executors,
    # speculation, non-unit jobs, or per-task dispatch observers are in
    # play; node failures mid-wave are caught by the same attempt/state
    # guards the per-event completion events use.  Observable behaviour —
    # event ordering, every timestamp, every stat — is identical
    # (tests/test_wavepath.py pins it differentially).
    _WAVE_NUMPY = 64     # waves at least this long use the numpy prefix sum

    def _take_wave(self, k: int):
        """Bulk ``_next_waiting``: up to k tasks from the requeue lane then
        the queue cursor walk.  Returns (tasks, groups, skips) where groups
        are (job, count) runs and skips is the per-task count of ghost
        entries consumed before that task (None when there were none) — the
        queue-depth recurrence must account for them."""
        tasks: List[Task] = []
        groups: List[Tuple[Job, int]] = []
        skips: Optional[List[int]] = None
        extra = 0
        consumed = 0
        rq = self._requeue
        if rq:
            active = self._active_jobs
            while rq and len(tasks) < k:
                t = rq.popleft()
                consumed += 1
                # same ghost filter as _next_waiting: a retired job's failed
                # original may still sit here WAITING
                if (t.state in (TaskState.WAITING, TaskState.PREEMPTED)
                        and t.job_id in active):
                    if skips is not None:
                        skips.append(extra)
                    tasks.append(t)
                    groups.append((active[t.job_id], 1))
                else:
                    if skips is None:
                        skips = [0] * len(tasks)
                    extra += 1
        if len(tasks) < k:
            qtasks, qgroups, qskips, qconsumed = self.qm.take_waiting(
                self._cursor, k - len(tasks))
            consumed += qconsumed
            if qtasks:
                if skips is not None or qskips is not None:
                    if skips is None:
                        skips = [0] * len(tasks)
                    if qskips is None:
                        skips.extend([extra] * len(qtasks))
                    else:
                        skips.extend(q + extra for q in qskips)
                tasks.extend(qtasks)
                groups.extend(qgroups)
        self._depth -= consumed
        return tasks, groups, skips

    def _cycle_wave(self) -> None:
        rm = self.rm
        nodes = rm.nodes
        stack = self._free_stack
        depth0 = self._depth
        if depth0 <= 0:
            return
        limit = self.config.max_dispatch_per_cycle
        cap = depth0 if not limit or depth0 < limit else limit
        # -- validated free slots, in per-event pop order.  The slot is
        # *claimed* (free_slots decremented) during validation, so duplicate
        # stale entries for the same node self-invalidate exactly as the
        # per-event loop's allocate-then-revalidate does; unused claims are
        # undone below when the task fetch comes up short.
        avail: List[int] = []
        avail_nodes: List = []
        UP = NodeState.UP
        while stack and len(avail) < cap:
            node = stack.pop()
            if node.state is UP and node.free_slots > 0:
                node.free_slots -= 1
                avail.append(node.node_id)
                avail_nodes.append(node)
            # else: stale entry — discarded, exactly as the per-event loop
        if not avail:
            return
        tasks, groups, skips = self._take_wave(len(avail))
        m = len(tasks)
        if m < len(avail):
            # unused claims undone, slots back in original stack order
            for node in avail_nodes[m:]:
                node.free_slots += 1
            stack.extend(reversed(avail_nodes[m:]))
            del avail[m:]
            del avail_nodes[m:]
        if m == 0:
            return
        keys = rm.allocate_unit_wave(tasks, avail, avail_nodes)
        wnodes = avail_nodes
        # -- closed-form serial clock + per-task bookkeeping, one fused
        # loop: the i-th dispatch (0-based) charges depth0 - i - skips[i];
        # clock_i is the sequential accumulation starting from
        # max(sched_clock, now).  Both arms reproduce the per-event float
        # ops exactly (np.cumsum is ufunc-sequential, and the scalar loop
        # is literally the per-event recurrence).
        prof = self.profile
        cc = prof.central_cost
        qc = prof.queue_coeff
        su = prof.startup_cost
        loop = self.loop
        now = loop.now
        s = self.sched_clock
        if now > s:
            s = now
        running = self._running_tasks
        RUNNING = TaskState.RUNNING
        ends: List[float] = []
        atts: List[int] = []
        end_app = ends.append
        att_app = atts.append
        observe = self.on_dispatch_batch is not None
        depths: Optional[List[int]] = [] if observe else None
        any_slow = rm._slow_nodes > 0
        if m >= self._WAVE_NUMPY:
            d = _np.arange(depth0, depth0 - m, -1, dtype=_np.float64)
            if skips is not None:
                d -= _np.asarray(skips, dtype=_np.float64)
            acc = _np.empty(m + 1)
            acc[0] = s
            acc[1:] = cc + qc * d
            _np.cumsum(acc, out=acc)
            clock_arr = acc[1:]
            clocks = clock_arr.tolist()
            starts = (clock_arr + su).tolist()
            s = clocks[m - 1]
            if observe:
                depths = ([depth0 - i for i in range(m)] if skips is None
                          else [depth0 - i - skips[i] for i in range(m)])
            for i, task in enumerate(tasks):
                task.state = RUNNING
                task.dispatch_time = clocks[i]
                st = starts[i]
                task.start_time = st
                dur = task.duration
                if any_slow:
                    slow = wnodes[i].slow
                    if slow != 1.0:   # same float ops as _dispatch
                        dur = dur * slow
                end_app(st + dur)
                a = task.attempts + 1
                task.attempts = a
                att_app(a)
                running[keys[i]] = task
        else:
            dcur = depth0
            i = 0
            for task in tasks:
                dq = dcur if skips is None else dcur - skips[i]
                s = s + (cc + qc * dq)
                dcur -= 1
                task.state = RUNNING
                task.dispatch_time = s
                st = s + su
                task.start_time = st
                dur = task.duration
                if any_slow:
                    slow = wnodes[i].slow
                    if slow != 1.0:   # same float ops as _dispatch
                        dur = dur * slow
                end_app(st + dur)
                a = task.attempts + 1
                task.attempts = a
                att_app(a)
                running[keys[i]] = task
                i += 1
                if depths is not None:
                    depths.append(dq)
        # -- per-job bookkeeping, once per (job, run)
        jp = self._job_pending
        stats = self.stats
        QUEUED = JobState.QUEUED
        pos = 0
        for job, count in groups:
            if job.state is QUEUED:
                job.state = JobState.RUNNING
                st0 = stats[job.job_id]
                if st0.first_dispatch == 0.0:
                    st0.first_dispatch = tasks[pos].dispatch_time
            jid = job.job_id
            jp[jid] = jp.get(jid, count) - count
            pos += count
        self._pending -= m
        self.dispatched += m
        self.sched_clock = s
        if observe:
            self.on_dispatch_batch(tasks, depths)
        # -- one coalesced completion event per wave, members in end-time
        # order (stable: equal ends keep dispatch order, matching the
        # per-event heap's sequence tie-break)
        for i in range(1, m):
            if ends[i] < ends[i - 1]:
                order = sorted(range(m), key=ends.__getitem__)
                tasks = [tasks[j] for j in order]
                ends = [ends[j] for j in order]
                atts = [atts[j] for j in order]
                keys = [keys[j] for j in order]
                wnodes = [wnodes[j] for j in order]
                break
        batch = _Wave(tasks, ends, atts, keys, wnodes, loop.reserve_seq())
        loop.at_seq(ends[0], batch.seq, self._finish_wave, batch)

    def _finish_wave(self, batch: "_Wave") -> None:
        """Coalesced completion: finish batch members in end-time order,
        yielding to the heap whenever a real event (cycle, arrival, another
        wave) would interleave; the remainder is re-pushed at the next
        member's end time under the batch's original sequence number, so
        every tie resolves exactly as per-event completion events would."""
        tasks = batch.tasks
        ends = batch.ends
        atts = batch.atts
        keys = batch.keys
        wnodes = batch.nodes
        seq = batch.seq
        pos = batch.pos
        n = len(tasks)
        loop = self.loop
        heap = loop._heap
        until = loop.until
        rm = self.rm
        dirty = rm._index_dirty
        free_stack = self._free_stack
        running = self._running_tasks
        active = self._active_jobs
        stats = self.stats
        prof = self.profile
        completion_cost = prof.completion_cost
        cycle_interval = prof.cycle_interval
        RUNNING = TaskState.RUNNING
        COMPLETED = TaskState.COMPLETED
        UP = NodeState.UP
        if not loop._running:
            # stop() took effect while this batch was queued; leave it be
            return
        # the straggler window only feeds _speculate; waves are only
        # dispatched with speculation off, so skip it unless the config
        # flipped mid-flight (then the per-event fallback keeps it warm)
        durations = self._durations if self.config.speculative else None
        # completion observer, hoisted like the other loop-invariant hooks.
        # It fires per drained member in exact per-event order; observers
        # must read task-intrinsic fields (end_time, node_id, ...) — the
        # drain's scalar state (sched_clock, completed, loop.now) is
        # deferred and only flushed at yields/retires.
        on_complete = self.on_complete
        # fault-plane state, hoisted: silent deaths and sweeps only change
        # between events, and the drain yields to every event, so these are
        # loop-invariant within one call (no-fault runs pay two comparisons)
        hidden = rm._hidden_dead > 0
        hb = self.config.heartbeat_interval > 0.0
        # deferred scalar state, flushed at yields and around subcalls that
        # observe it (_retire -> on_job_done may submit; _task_end reads
        # and advances the clock).  The heap-head yield bound is likewise
        # hoisted and refreshed only when this loop itself pushes events.
        s = self.sched_clock
        ccount = 0                       # completions drained this call
        freed = 0                        # UP-node slots released
        last_e = loop.now                # end time of the last member drained
        if heap:
            top = heap[0]
            btime = top[0]
            bseq = top[1]
        else:
            btime = until
            bseq = seq + 1               # nothing queued: never ties
        need_cycle = True
        jid_cache = -1
        job = None
        st = None
        done_at = 0
        while pos < n:
            e = ends[pos]
            if e > btime or (e == btime and seq > bseq):
                break                    # a real event interleaves: yield
            if e > until:
                break
            task = tasks[pos]
            att = atts[pos]
            # stale member: the node failed mid-wave and the task was
            # requeued/re-dispatched — same guard as _finish_sim/_task_end
            if task.attempts != att or task.state is not RUNNING:
                pos += 1
                last_e = e
                continue
            # silently-dead node: the completion never happens (same
            # suppression as _task_end; the task stays RUNNING until a
            # heartbeat sweep detects the lapse and requeues it)
            if hidden and not wnodes[pos].alive:
                pos += 1
                last_e = e
                continue
            if self._clones:
                # speculation switched on mid-flight: take the general path.
                # (_clones empty implies no live clone can be RUNNING: a
                # clone's registry entry outlives it — resolution either
                # completes the clone or cancels it, and the state guard
                # above already filtered cancelled members.)
                loop.advance(e)
                self.sched_clock = s
                rm._free_slots += freed
                freed = 0
                self.completed += ccount
                ccount = 0
                pos += 1
                last_e = e
                self._task_end(task, True)
                if not loop._running:
                    break
                s = self.sched_clock
                jid_cache = -1
                need_cycle = True
                if heap:
                    top = heap[0]
                    btime = top[0]
                    bseq = top[1]
                continue
            pos += 1
            last_e = e
            key = keys[pos - 1]
            task.end_time = e
            task.state = COMPLETED
            del running[key]
            # inline rm.release_unit (the per-member hot path)
            node = wnodes[pos - 1]
            nrun = node.running
            if key in nrun:
                nrun.discard(key)
                node.free_slots += 1
                if node.state is UP:
                    freed += 1
                    dirty.add(node.node_id)
            free_stack.append(node)
            if hb:
                # task activity is a heartbeat (matches _task_end)
                node.last_heartbeat = e
            s = (s if s > e else e) + completion_cost
            ccount += 1
            if durations is not None:
                durations.append(max(e - task.start_time, 1e-9))
                self._dur_version += 1
            if on_complete is not None:
                on_complete(task, True)
            jid = task.job_id
            if jid != jid_cache:
                job = active.get(jid)
                jid_cache = jid
                if job is None:
                    continue
                st = stats[jid]
                done_at = len(job.tasks) - job.n_clones - job.failed_tasks
            elif job is None:
                continue
            c = job.completed_tasks + 1
            job.completed_tasks = c
            st.task_seconds += task.duration
            if e > st.last_end:
                st.last_end = e
            if c >= done_at:
                loop.advance(e)
                self.sched_clock = s
                rm._free_slots += freed
                freed = 0
                self.completed += ccount
                ccount = 0
                self._retire(job, self._terminal_state(job), e)
                if not loop._running:
                    break
                s = self.sched_clock
                jid_cache = -1
                need_cycle = True
                if heap:
                    top = heap[0]
                    btime = top[0]
                    bseq = top[1]
            if need_cycle:
                # inline _request_cycle; later members' times only grow, so
                # once deduped (or scheduled) it stays deduped this drain
                t = (e if e > s else s) + cycle_interval
                nc = self._next_cycle
                if nc is None or nc > t:
                    self._next_cycle = t
                    loop.at(t, self._cycle)
                    top = heap[0]
                    btime = top[0]
                    bseq = top[1]
                need_cycle = False
        # flush deferred state
        self.sched_clock = s
        self.completed += ccount
        rm._free_slots += freed
        loop.advance(last_e)
        batch.pos = pos
        if pos < n:
            loop.at_seq(ends[pos], seq, self._finish_wave, batch)

    # ------------------------------------------------- arena span (SoA)
    # While the span holds, dispatch and completion never touch a Task or
    # Node object: the free-capacity stack is an int32 node-id array, waves
    # are numpy slab rows, and per-job state is a handful of scalars.  The
    # span's *conditions* are exactly the wave path's plus "no per-member
    # observers and no fault machinery in play" — everything the object
    # drain handles per member (stale attempts, hidden-dead suppression,
    # clone resolution, heartbeat stamping) is structurally impossible
    # inside a span, because any event that could cause it exits the span
    # first (ResourceManager.on_pre_change, non-eligible submits, config
    # drift checks each cycle and each drain).

    def _span_ok(self) -> bool:
        c = self.config
        rm = self.rm
        return (c.wave_batching and not c.speculative
                and c.heartbeat_interval == 0.0
                and self.on_dispatch is None
                and self.on_dispatch_batch is None
                and self.on_complete is None
                and not self._clones
                and rm._hidden_dead == 0 and rm._slow_nodes == 0
                and len(rm._up_ids) == len(rm.nodes))

    def _enter_span(self) -> bool:
        """Freeze the object free-slot stack into the numpy stack.

        Replays the object path's claim loop (pop order, per-node remaining
        counts) so stale entries die in exactly the same order; entry is
        refused when the stack does not account for every free slot (the
        cycle then runs the object path — identical either way)."""
        rm = self.rm
        stack = self._free_stack
        ids: List[int] = []
        if stack:
            remaining: Dict[int, int] = {}
            UP = NodeState.UP
            for node in reversed(stack):          # pop order
                nid = node.node_id
                r = remaining.get(nid)
                if r is None:
                    r = node.free_slots if node.state is UP else 0
                if r > 0:
                    ids.append(nid)
                    remaining[nid] = r - 1
            ids.reverse()                         # ids[-1] pops first
        else:
            for node in rm.free_nodes():
                ids.extend([node.node_id] * node.free_slots)
        k = len(ids)
        if k != rm._free_slots:
            return False
        need = rm._total_slots
        if need < 1:
            need = 1
        fs = self._fs
        if fs is None or len(fs) < need:
            fs = self._fs = _np.empty(need, dtype=_np.int32)
        if k:
            fs[:k] = ids
        self._fs_top = k
        self._span = True
        self._free_stack = []
        return True

    def _arena_source(self) -> bool:
        """EventLoop refill source: a drained heap with arena residue owes
        a span exit so ``run()`` returns with consistent object state."""
        if self._span or self._arena_q or self._arena_waves:
            self._exit_span()
            return bool(self.loop._heap)
        return False

    def _cycle_arena(self) -> None:
        """Span dispatch: the cross-job wave.  One contiguous slab of tasks
        spanning many FIFO jobs, the same closed-form serial-clock prefix
        sum as ``_cycle_wave``, zero Task/Node objects touched."""
        depth0 = self._depth
        if depth0 <= 0:
            return
        loop = self.loop
        prof = self.profile
        if (not loop._heap and not self._arena_waves and loop._running
                and loop.until == float("inf") and self.on_cycle is None
                and self.on_job_done is None and not self.qm._dependents
                and prof.central_cost >= 0.0 and prof.queue_coeff >= 0.0
                and prof.completion_cost >= 0.0
                and prof.cycle_interval >= 0.0
                and "_finish_arena" not in self.__dict__):
            # the span owns the entire future: no pending events, no wave
            # in flight, no observer or callback to fire — the whole lane
            # backlog is a deterministic recurrence.  Fast-forward it.
            return self._span_burst()
        top = self._fs_top
        limit = self.config.max_dispatch_per_cycle
        cap = depth0 if not limit or depth0 < limit else limit
        if cap > top:
            cap = top
        if cap <= 0:
            return
        q = self._arena_q
        runs: List[Tuple[Job, int, int, int]] = []
        m = 0
        off = self._arena_off
        while m < cap and q:
            job = q[0]
            if job._tasks is not None:
                break       # externally materialized: not slab-dispatchable
            avail = job._lazy[0] - off
            take = cap - m
            if take >= avail:
                take = avail
                q.popleft()
                runs.append((job, m, take, off))
                m += take
                off = 0
            else:
                runs.append((job, m, take, off))
                m += take
                off += take
                break
        self._arena_off = off
        if m == 0:
            if q:           # materialized head blocks the lane: leave it
                self._exit_span()
                self._cycle_fast()
            return
        fs = self._fs
        nids = fs[top - m:top][::-1].copy()       # dispatch (pop) order
        self._fs_top = top - m
        # -- closed-form serial clock, both arms bit-identical to the
        # object wave path (skips are impossible on the lane: no requeue
        # entries, no non-WAITING cursor ghosts)
        prof = self.profile
        cc = prof.central_cost
        qc = prof.queue_coeff
        su = prof.startup_cost
        loop = self.loop
        now = loop.now
        s = self.sched_clock
        if now > s:
            s = now
        if m >= self._WAVE_NUMPY:
            d = _np.arange(depth0, depth0 - m, -1, dtype=_np.float64)
            acc = _np.empty(m + 1)
            acc[0] = s
            acc[1:] = cc + qc * d
            _np.cumsum(acc, out=acc)
            clocks = acc[1:].copy()
            s = float(clocks[m - 1])
        else:
            clocks = _np.empty(m)
            for i in range(m):
                s = s + (cc + qc * (depth0 - i))
                clocks[i] = s
        starts = clocks + su
        ends_d = _np.empty(m)
        arena = self._arena
        jp = self._job_pending
        stats = self.stats
        cursor = self._cursor
        QUEUED = JobState.QUEUED
        for job, mstart, count, off0 in runs:
            sl = slice(mstart, mstart + count)
            nspec, duration, durations, _req = job._lazy
            if durations is None:
                ends_d[sl] = starts[sl] + duration
            else:
                ends_d[sl] = starts[sl] + _np.asarray(
                    durations[off0:off0 + count], dtype=_np.float64)
            if job._lo < 0:
                arena.alloc(job, nspec)
            job._filled = off0 + count
            jid = job.job_id
            cursor[jid] = off0 + count
            jp[jid] = jp.get(jid, count) - count
            if job.state is QUEUED:
                job.state = JobState.RUNNING
                st0 = stats[jid]
                if st0.first_dispatch == 0.0:
                    st0.first_dispatch = float(clocks[mstart])
        self._pending -= m
        self._depth -= m
        self.dispatched += m
        self.sched_clock = s
        self.rm._free_slots -= m
        # -- one coalesced completion event per wave (end order; stable
        # sort matches the object path's sequence tie-break)
        batch = _ArenaWave()
        batch.runs = runs
        batch.clocks = clocks
        batch.ends_d = ends_d
        batch.nids_d = nids
        asc = True if m <= 1 else bool((ends_d[1:] >= ends_d[:-1]).all())
        if asc:
            batch.ends = ends_d.tolist()
            batch.nids = nids
        else:
            order = _np.argsort(ends_d, kind="stable")
            batch.order = order
            batch.ends = ends_d[order].tolist()
            batch.nids = nids[order]
            djobs: List[Job] = [None] * m
            ddurs: List[float] = [0.0] * m
            for job, mstart, count, off0 in runs:
                durations = job._lazy[2]
                if durations is None:
                    dur = job._lazy[1]
                    for di in range(mstart, mstart + count):
                        djobs[di] = job
                        ddurs[di] = dur
                else:
                    for di in range(mstart, mstart + count):
                        djobs[di] = job
                        ddurs[di] = durations[off0 + di - mstart]
            ol = order.tolist()
            batch.mem_jobs = [djobs[di] for di in ol]
            batch.mem_durs = [ddurs[di] for di in ol]
        self._arena_waves.add(batch)
        seq = loop.reserve_seq()
        batch.seq = seq
        loop.at_seq(batch.ends[0], seq, self._finish_arena, batch)

    def _span_burst(self) -> None:
        """Closed-form span fast-forward: drain the whole lane backlog in
        one call.

        Inside a pure span with an empty heap and no wave in flight, every
        future micro-event — wave dispatches, member completions, cycle
        pushes — is a deterministic recurrence over (serial clock, free-slot
        stack, FIFO backlog): nothing external can interleave (any node or
        config change exits the span first, and the gate in ``_cycle_arena``
        requires that no observer, ``on_job_done`` hook, dependency edge, or
        finite run horizon exists).  So instead of bouncing each ~10-member
        sub-wave through the event loop, this simulates the exact same event
        schedule — identical (time, seq) tie-breaks, identical float ops,
        identical retire/need-cycle ordering — in one tight pass, writing
        dispatch/end/node slabs in large contiguous chunks.  The loop's
        sequence counter is kept in sync (every virtual wave and cycle push
        reserves a real seq) and the clock lands on the same final value the
        event-driven schedule reaches, so the scheduler, arena, and loop end
        bit-identical to the un-fast-forwarded run."""
        loop = self.loop
        rm = self.rm
        arena = self._arena
        q = self._arena_q
        jp = self._job_pending
        cursor = self._cursor
        stats = self.stats
        finished = self.qm._finished
        active = self._active_jobs
        arena_jobs = self._arena_jobs
        write_run = arena.write_run
        adisp = arena._disp
        arefs = arena._refs
        prof = self.profile
        cc = prof.central_cost
        qc = prof.queue_coeff
        su = prof.startup_cost
        cpc = prof.completion_cost
        ci = prof.cycle_interval
        limit = self.config.max_dispatch_per_cycle
        reserve = loop._seq.__next__          # reserve_seq, sans the call
        heappush = heapq.heappush
        heappop = heapq.heappop
        bisect_left = bisect.bisect_left
        bisect_right = bisect.bisect_right
        QUEUED = JobState.QUEUED
        RUNNINGJ = JobState.RUNNING
        COMPLETED = JobState.COMPLETED

        depth = self._depth
        s = self.sched_clock
        now = loop.now
        free: List[int] = self._fs[:self._fs_top].tolist()
        off = self._arena_off
        dispatched = 0
        completed = 0
        wave_numpy = self._WAVE_NUMPY
        retired: List[Job] = []
        retired_app = retired.append
        # slab write buffer: each wave contributes its (clocks, ends, nids)
        # triple; rows are contiguous in dispatch order (alloc order ==
        # dispatch order == tid order on the lane), concatenated and
        # written in big chunks so the numpy assignment amortizes
        parts: List[tuple] = []
        parts_app = parts.append
        buf_base = -1
        buf_len = 0
        next_cycle: Optional[float] = None   # self._next_cycle is None here
        # virtual heap: (time, seq, wave-or-None); None = a cycle event.
        # The sentinel replays the cycle currently firing (this call).
        H: List[tuple] = [(now, -1, None)]
        while H:
            t_e, seq_e, w = heappop(H)
            now = t_e
            if w is None:
                # ------------------------------- cycle: dispatch round
                next_cycle = None
                if depth <= 0:
                    continue
                cap = depth if not limit or depth < limit else limit
                nfree = len(free)
                if cap > nfree:
                    cap = nfree
                if cap <= 0:
                    continue
                if now > s:
                    s = now
                depth0 = depth
                m = 0
                runs: List[Tuple[Job, int, int, int]] = []
                ends_w: List[float] = []
                nids_w: List[int] = []
                clocks_w: List[float] = []
                e_app = ends_w.append
                n_app = nids_w.append
                c_app = clocks_w.append
                pop_free = free.pop
                asc = True
                prev_e = float("-inf")
                while m < cap and q:
                    job = q[0]
                    nspec, duration, durations, _req = job._lazy
                    avail = nspec - off
                    take = cap - m
                    if take >= avail:
                        take = avail
                        q.popleft()
                        newoff = 0
                    else:
                        newoff = off + take
                    lo = job._lo
                    if lo < 0:
                        # inlined Arena.alloc fast path: the run fits one
                        # resident chunk (the overwhelmingly common case)
                        lo = arena._n
                        c0 = lo >> _CHUNK_BITS
                        if (c0 == (lo + nspec - 1) >> _CHUNK_BITS
                                and c0 in adisp):
                            arena._n = lo + nspec
                            arefs[c0] += 1
                            job._arena = arena
                            job._lo = lo
                        else:
                            arena.alloc(job, nspec)
                            lo = job._lo
                    if buf_base < 0:
                        buf_base = lo + off
                    elif buf_base + buf_len + m != lo + off:
                        # unreachable on the lane (alloc order == dispatch
                        # order == tid order); a hole would silently mis-
                        # place slab rows, so fail loudly instead
                        raise RuntimeError(
                            "arena span: non-contiguous slab run")
                    if take >= wave_numpy:
                        # numpy arm: per-run cumsum with the carried clock
                        # is the same left-fold as the event path's whole-
                        # wave cumsum (ufunc-sequential), bit for bit
                        d = _np.arange(depth0 - m, depth0 - m - take, -1,
                                       dtype=_np.float64)
                        acc = _np.empty(take + 1)
                        acc[0] = s
                        acc[1:] = cc + qc * d
                        _np.cumsum(acc, out=acc)
                        clocks_a = acc[1:]
                        s = float(clocks_a[take - 1])
                        if durations is None:
                            ends_a = (clocks_a + su) + duration
                        else:
                            ends_a = (clocks_a + su) + _np.asarray(
                                durations[off:off + take],
                                dtype=_np.float64)
                        el = ends_a.tolist()
                        if (el[0] < prev_e
                                or not bool(
                                    (ends_a[1:] >= ends_a[:-1]).all())):
                            asc = False
                        prev_e = el[take - 1]
                        ends_w += el
                        clocks_w += clocks_a.tolist()
                        nds = free[-take:]
                        del free[-take:]
                        nds.reverse()
                        nids_w += nds
                    elif durations is None:
                        # uniform duration + non-negative costs (the gate
                        # requires them): ends are non-decreasing within
                        # the run, so only the run boundary needs an
                        # ascending check
                        dm = depth0 - m
                        s = s + (cc + qc * dm)
                        e = (s + su) + duration
                        if e < prev_e:
                            asc = False
                        c_app(s)
                        e_app(e)
                        n_app(pop_free())
                        for k in range(1, take):
                            s = s + (cc + qc * (dm - k))
                            e = (s + su) + duration
                            c_app(s)
                            e_app(e)
                            n_app(pop_free())
                        prev_e = e
                    else:
                        dm = depth0 - m
                        for k in range(take):
                            s = s + (cc + qc * (dm - k))
                            e = (s + su) + durations[off + k]
                            if e < prev_e:
                                asc = False
                            prev_e = e
                            c_app(s)
                            e_app(e)
                            n_app(pop_free())
                    runs.append((job, m, take, off))
                    # pending/cursor bookkeeping is skipped: the burst
                    # retires every lane job, so those maps are bulk-
                    # cleared at the end (same final state)
                    if job.state is QUEUED:
                        job.state = RUNNINGJ
                        st0 = stats[job.job_id]
                        if st0.first_dispatch == 0.0:
                            st0.first_dispatch = clocks_w[m]
                    m += take
                    off = newoff
                depth -= m
                dispatched += m
                parts_app((clocks_w, ends_w, nids_w))
                buf_len += m
                if asc:
                    wave = [ends_w, nids_w, runs, None, 0, 0]
                else:
                    # stable end-order sort, exactly the event-driven tie
                    # rule (equal ends keep dispatch order)
                    djobs: List[Job] = [None] * m
                    ddurs: List[float] = [0.0] * m
                    for job, mstart, count, off0 in runs:
                        durations = job._lazy[2]
                        if durations is None:
                            dur = job._lazy[1]
                            for di in range(mstart, mstart + count):
                                djobs[di] = job
                                ddurs[di] = dur
                        else:
                            for di in range(mstart, mstart + count):
                                djobs[di] = job
                                ddurs[di] = durations[off0 + di - mstart]
                    order = sorted(range(m), key=ends_w.__getitem__)
                    ends_w = [ends_w[i] for i in order]
                    nids_w = [nids_w[i] for i in order]
                    wave = [ends_w, nids_w,
                            [djobs[i] for i in order],
                            [ddurs[i] for i in order], 0, -1]
                heappush(H, (ends_w[0], reserve(), wave))
                if buf_len >= 32768:
                    # bounded-memory flush: retired (recycled) chunks are
                    # skipped inside write_run
                    fc: List[float] = []
                    fe: List[float] = []
                    fn: List[int] = []
                    for pc, pe, pn in parts:
                        fc += pc
                        fe += pe
                        fn += pn
                    write_run(buf_base, fc, fe, fn, 2)
                    buf_base += buf_len
                    buf_len = 0
                    del parts[:]
            elif w[5] >= 0:
                # --------------------- ascending wave: chunked drain
                ends_w, nids_w, runs, _, pos, ri = w
                nw = len(ends_w)
                # fused resumption: the event path drains one member, then
                # arms the next cycle from it — but with non-negative costs
                # that arm time is max(s, e) + cpc + ci, known *before*
                # draining, and a wave's head member is always drainable at
                # its own pop (nothing in H can precede it).  Arm first,
                # then sweep the whole bisect window in one chunk instead
                # of a one-member chunk plus a second pass.
                e = ends_w[pos]
                t2 = ((s if s > e else e) + cpc) + ci
                if next_cycle is None or next_cycle > t2:
                    next_cycle = t2
                    heappush(H, (t2, reserve(), None))
                need_cycle = False
                while pos < nw:
                    job, mstart, count, off0 = runs[ri]
                    run_end = mstart + count
                    hi = run_end
                    if H:
                        h0 = H[0]
                        bt = h0[0]
                        if seq_e > h0[1]:
                            hb = bisect_left(ends_w, bt, pos, hi)
                        else:
                            hb = bisect_right(ends_w, bt, pos, hi)
                        if hb < hi:
                            hi = hb
                    if hi <= pos:
                        break
                    st0 = stats[job.job_id]
                    tsv = st0.task_seconds
                    durations = job._lazy[2]
                    if durations is None:
                        dur = job._lazy[1]
                        for e in ends_w[pos:hi]:
                            s = (s if s > e else e) + cpc
                            tsv += dur
                    else:
                        dbase = off0 - mstart
                        for i in range(pos, hi):
                            e = ends_w[i]
                            s = (s if s > e else e) + cpc
                            tsv += durations[dbase + i]
                    st0.task_seconds = tsv
                    k = hi - pos
                    if e > st0.last_end:
                        st0.last_end = e
                    job.completed_tasks += k
                    free += nids_w[pos:hi]
                    completed += k
                    pos = hi
                    if pos == run_end:
                        ri += 1
                        if job.completed_tasks >= job._lazy[0]:
                            job.state = COMPLETED
                            job.end_time = e
                            job._filled = job._lazy[0]
                            retired_app(job)
                            need_cycle = True
                    if need_cycle:
                        t2 = (e if e > s else s) + ci
                        if next_cycle is None or next_cycle > t2:
                            next_cycle = t2
                            heappush(H, (t2, reserve(), None))
                        need_cycle = False
                w[4] = pos
                w[5] = ri
                if pos < nw:
                    heappush(H, (ends_w[pos], seq_e, w))
            else:
                # ------------------- non-ascending wave: per-member drain
                ends_w, nids_w, mem_jobs, mem_durs, pos, _ = w
                nw = len(ends_w)
                need_cycle = True
                while pos < nw:
                    e = ends_w[pos]
                    if H:
                        h0 = H[0]
                        if e > h0[0] or (e == h0[0] and seq_e > h0[1]):
                            break
                    job = mem_jobs[pos]
                    s = (s if s > e else e) + cpc
                    free.append(nids_w[pos])
                    completed += 1
                    c = job.completed_tasks + 1
                    job.completed_tasks = c
                    st0 = stats[job.job_id]
                    st0.task_seconds += mem_durs[pos]
                    if e > st0.last_end:
                        st0.last_end = e
                    pos += 1
                    if c >= job._lazy[0]:
                        job.state = COMPLETED
                        job.end_time = e
                        job._filled = job._lazy[0]
                        retired_app(job)
                        need_cycle = True
                    if need_cycle:
                        t2 = (e if e > s else s) + ci
                        if next_cycle is None or next_cycle > t2:
                            next_cycle = t2
                            heappush(H, (t2, reserve(), None))
                        need_cycle = False
                w[4] = pos
                if pos < nw:
                    heappush(H, (ends_w[pos], seq_e, w))
        # ------------------------------------------------ final flush
        if buf_len:
            if len(parts) == 1:
                fc, fe, fn = parts[0]
            else:
                fc, fe, fn = [], [], []
                for pc, pe, pn in parts:
                    fc += pc
                    fe += pe
                    fn += pn
            write_run(buf_base, fc, fe, fn, 2)
        if retired:
            # vectorized whole-job retirement: the burst completed every
            # lane job (and the span invariant says active == lane), so
            # the per-job map pops collapse to bulk clears and the per-
            # chunk ref decrements to one arena sweep
            for job in retired:
                finished[job.job_id] = COMPLETED
            jp.clear()
            cursor.clear()
            arena_jobs.clear()
            active.clear()
            arena.release_span()
        self._depth = depth
        self._pending -= dispatched
        self.dispatched += dispatched
        self.completed += completed
        self.sched_clock = s
        self._arena_off = off
        k = len(free)
        if k:
            self._fs[:k] = free
        self._fs_top = k
        loop.advance(now)

    def _finish_arena(self, batch: "_ArenaWave") -> None:
        """Span drain: ``_finish_wave`` over slab rows.  Same yield bounds,
        same deferred-scalar discipline, same retire/need-cycle ordering —
        minus the per-member fault guards (structurally impossible here).
        Ascending waves drain in per-run *chunks*: one fused scalar loop for
        the completion-cost recurrence and task-seconds sum, one numpy slice
        for the free-slot release, per-job bookkeeping once per chunk."""
        if batch.converted is not None:
            return self._finish_wave(batch.converted)
        loop = self.loop
        if not loop._running:
            return
        if (self.on_complete is not None or self.config.speculative
                or self._clones or self.rm._hidden_dead
                or self.config.heartbeat_interval > 0.0):
            # config drifted since dispatch: hand the wave to the object
            # drain (conversion flushes slabs and materializes views)
            self._exit_span()
            return self._finish_wave(batch.converted)
        ends = batch.ends
        nids = batch.nids
        runs = batch.runs
        pos = batch.pos
        ri = batch.ri
        n = len(ends)
        seq = batch.seq
        heap = loop._heap
        until = loop.until
        rm = self.rm
        qm = self.qm
        prof = self.profile
        completion_cost = prof.completion_cost
        cycle_interval = prof.cycle_interval
        fs = self._fs
        top = self._fs_top
        stats = self.stats
        jp = self._job_pending
        COMPLETED = JobState.COMPLETED
        # deferred scalars (flushed at yields and around _retire)
        s = self.sched_clock
        ccount = 0
        freed = 0
        last_e = loop.now
        if heap:
            h0 = heap[0]
            btime = h0[0]
            bseq = h0[1]
        else:
            btime = until
            bseq = seq + 1               # nothing queued: never ties
        need_cycle = True
        if batch.order is None:
            # ---------------- ascending: chunked per-run drain
            while pos < n:
                job, mstart, count, off0 = runs[ri]
                run_end = mstart + count
                # while a cycle push is owed, chunks are single members
                # (the push must fire right after that member, as the
                # per-member path does)
                hi = pos + 1 if need_cycle else run_end
                if seq > bseq:
                    hb = bisect.bisect_left(ends, btime, pos, hi)
                else:
                    hb = bisect.bisect_right(ends, btime, pos, hi)
                if hb < hi:
                    hi = hb
                hu = bisect.bisect_right(ends, until, pos, hi)
                if hu < hi:
                    hi = hu
                if hi <= pos:
                    break                # a real event interleaves: yield
                st0 = stats[job.job_id]
                tsv = st0.task_seconds
                durations = job._lazy[2]
                if durations is None:
                    dur = job._lazy[1]
                    for i in range(pos, hi):
                        e = ends[i]
                        s = (s if s > e else e) + completion_cost
                        tsv += dur
                else:
                    dbase = off0 - mstart
                    for i in range(pos, hi):
                        e = ends[i]
                        s = (s if s > e else e) + completion_cost
                        tsv += durations[dbase + i]
                st0.task_seconds = tsv
                k = hi - pos
                e = ends[hi - 1]
                if e > st0.last_end:
                    st0.last_end = e
                job.completed_tasks += k
                fs[top:top + k] = nids[pos:hi]
                top += k
                freed += k
                ccount += k
                last_e = e
                pos = hi
                if pos == run_end:
                    ri += 1
                    if job.completed_tasks >= job._lazy[0]:
                        jid = job.job_id
                        if self.on_job_done is None and not qm._dependents:
                            # inline _retire (span form: depth delta is 0,
                            # no deps, no unit/nonunit entry, no observer)
                            qm._finished[jid] = COMPLETED
                            job.state = COMPLETED
                            job.end_time = e
                            jp.pop(jid, None)
                            self._cursor.pop(jid, None)
                            self._arena_jobs.discard(jid)
                            del self._active_jobs[jid]
                            self._arena.release(job)
                        else:
                            batch.pos = pos
                            batch.ri = ri
                            loop.advance(e)
                            self.sched_clock = s
                            rm._free_slots += freed
                            freed = 0
                            self.completed += ccount
                            ccount = 0
                            self._fs_top = top
                            self._retire(job, COMPLETED, e)
                            if batch.converted is not None:
                                # on_job_done submitted a non-eligible job:
                                # the span is gone and this very wave was
                                # converted mid-drain — delegate
                                w = batch.converted
                                if loop._running:
                                    return self._finish_wave(w)
                                if w.pos < n:
                                    loop.at_seq(w.ends[w.pos], seq,
                                                self._finish_wave, w)
                                return
                            if not loop._running:
                                break
                            s = self.sched_clock
                            top = self._fs_top
                            if heap:
                                h0 = heap[0]
                                btime = h0[0]
                                bseq = h0[1]
                            else:
                                btime = until
                                bseq = seq + 1
                        need_cycle = True
                if need_cycle:
                    t = (e if e > s else s) + cycle_interval
                    nc = self._next_cycle
                    if nc is None or nc > t:
                        self._next_cycle = t
                        loop.at(t, self._cycle)
                        h0 = heap[0]
                        btime = h0[0]
                        bseq = h0[1]
                    need_cycle = False
        else:
            # ---------------- non-ascending: per-member drain
            mem_jobs = batch.mem_jobs
            mem_durs = batch.mem_durs
            while pos < n:
                e = ends[pos]
                if e > btime or (e == btime and seq > bseq):
                    break
                if e > until:
                    break
                job = mem_jobs[pos]
                s = (s if s > e else e) + completion_cost
                fs[top] = nids[pos]
                top += 1
                freed += 1
                ccount += 1
                last_e = e
                c = job.completed_tasks + 1
                job.completed_tasks = c
                st0 = stats[job.job_id]
                st0.task_seconds += mem_durs[pos]
                if e > st0.last_end:
                    st0.last_end = e
                pos += 1
                if c >= job._lazy[0]:
                    jid = job.job_id
                    if self.on_job_done is None and not qm._dependents:
                        qm._finished[jid] = COMPLETED
                        job.state = COMPLETED
                        job.end_time = e
                        jp.pop(jid, None)
                        self._cursor.pop(jid, None)
                        self._arena_jobs.discard(jid)
                        del self._active_jobs[jid]
                        self._arena.release(job)
                    else:
                        batch.pos = pos
                        loop.advance(e)
                        self.sched_clock = s
                        rm._free_slots += freed
                        freed = 0
                        self.completed += ccount
                        ccount = 0
                        self._fs_top = top
                        self._retire(job, COMPLETED, e)
                        if batch.converted is not None:
                            w = batch.converted
                            if loop._running:
                                return self._finish_wave(w)
                            if w.pos < n:
                                loop.at_seq(w.ends[w.pos], seq,
                                            self._finish_wave, w)
                            return
                        if not loop._running:
                            break
                        s = self.sched_clock
                        top = self._fs_top
                        if heap:
                            h0 = heap[0]
                            btime = h0[0]
                            bseq = h0[1]
                        else:
                            btime = until
                            bseq = seq + 1
                    need_cycle = True
                if need_cycle:
                    t = (e if e > s else s) + cycle_interval
                    nc = self._next_cycle
                    if nc is None or nc > t:
                        self._next_cycle = t
                        loop.at(t, self._cycle)
                        h0 = heap[0]
                        btime = h0[0]
                        bseq = h0[1]
                    need_cycle = False
        # flush deferred state
        self.sched_clock = s
        self.completed += ccount
        rm._free_slots += freed
        loop.advance(last_e)
        self._fs_top = top
        batch.pos = pos
        batch.ri = ri
        if pos < n:
            loop.at_seq(ends[pos], seq, self._finish_arena, batch)
        else:
            # wave fully drained: retire it to the slabs (a handful of
            # slice writes; recycled chunks of already-released jobs are
            # skipped inside write_run)
            self._arena_waves.discard(batch)
            arena = self._arena
            clocks = batch.clocks
            ends_d = batch.ends_d
            nids_d = batch.nids_d
            for job, mstart, count, off0 in batch.runs:
                arena.write_run(job._lo + off0,
                                clocks[mstart:mstart + count],
                                ends_d[mstart:mstart + count],
                                nids_d[mstart:mstart + count], 2)

    def _exit_span(self) -> None:
        """Leave the arena span, restoring full object state mid-run.

        Idempotent; a no-op without arena residue.  In order: flush every
        in-flight wave's slab rows (per-member states), materialize Task
        views for the jobs those waves still own, rebuild Node-level
        occupancy and the object free-slot stack from the numpy stack,
        convert in-flight ``_ArenaWave``s to ``_Wave``s (their pending heap
        events — original seq preserved — delegate), and adopt still-queued
        lane jobs back into the QueueManager in FIFO order."""
        if not (self._span or self._arena_waves or self._arena_q):
            return
        span = self._span
        rm = self.rm
        arena = self._arena
        active = self._active_jobs
        waves = list(self._arena_waves)
        # (1) slab flush: completed members state 2, in-flight state 1
        for b in waves:
            nb = len(b.ends)
            st = _np.ones(nb, dtype=_np.uint8)
            if b.pos:
                if b.order is None:
                    st[:b.pos] = 2
                else:
                    st[b.order[:b.pos]] = 2
            for job, mstart, count, off0 in b.runs:
                arena.write_run(job._lo + off0,
                                b.clocks[mstart:mstart + count],
                                b.ends_d[mstart:mstart + count],
                                b.nids_d[mstart:mstart + count],
                                st[mstart:mstart + count])
        # (2) materialize views for live wave jobs (retired ones need no
        # objects: no live members, and their slabs are complete)
        for b in waves:
            for job, _, _, _ in b.runs:
                if job.job_id in active and job._tasks is None:
                    arena._build_tasks(job)
        running = self._running_tasks
        nodes = rm.nodes
        if span:
            # (3) Node-level occupancy: only span members can be running
            # (entry required an empty running set), so reset and re-add
            for node in nodes.values():
                node.free_slots = node.slots
                node.running.clear()
        # (4) convert in-flight waves to object waves
        for b in waves:
            nb = len(b.ends)
            dtasks: List[Optional[Task]] = [None] * nb
            for job, mstart, count, off0 in b.runs:
                if job.job_id in active:
                    jts = job._tasks
                    base = off0 - mstart
                    for di in range(mstart, mstart + count):
                        dtasks[di] = jts[base + di]
            if b.order is None:
                etasks = dtasks
            else:
                etasks = [dtasks[di] for di in b.order.tolist()]
            enids = b.nids.tolist()
            wnodes = [nodes[nid] for nid in enids]
            keys = [(-1, -1) if t is None else (t.job_id, t.index)
                    for t in etasks]
            for e in range(b.pos, nb):
                task = etasks[e]
                key = keys[e]
                node = wnodes[e]
                node.free_slots -= 1
                node.running.add(key)
                running[key] = task
            w = _Wave(etasks, b.ends, [1] * nb, keys, wnodes, b.seq)
            w.pos = b.pos
            b.converted = w
        if span:
            # (5) aggregates: counters stayed exact; index/cache did not
            rm._index_dirty.update(nodes.keys())
            rm._free_cache = None
            # (6) object free-slot stack from the numpy stack (same order)
            self._free_stack = [nodes[i]
                                for i in self._fs[:self._fs_top].tolist()]
        # (7) still-queued lane jobs rejoin the QueueManager (deque order
        # == submit order == FIFO dispatch order; a partially-fetched head
        # resumes at its _cursor offset)
        qm = self.qm
        for job in self._arena_q:
            qm.adopt(job, job.submit_time)
        self._arena_q.clear()
        self._arena_jobs.clear()
        self._arena_waves.clear()
        self._arena_off = 0
        self._span = False
        self._fs_top = 0

    def _cycle_policy(self) -> None:
        self._free_stack = []  # invalidated by generic allocation
        self.rm.sync_index()   # reconcile any deferred wave-path updates
        now = self.loop.now
        # the latency model charges the seed's recomputed
        # sum(len(j.pending_tasks())) depth, which the incremental counter
        # reproduces exactly
        depth = self._pending
        self.policy.zero_slot_backlog = self._pending_zero
        try:
            if self.config.preemption:
                # exact seed walk: the preemption beneficiary is the head
                # of the full eligible list even when it has no pending
                # tasks
                head: Optional[Job] = None
                jobs: List[Job] = []
                for j in self.qm.iter_queued(now):
                    if j.state not in (JobState.QUEUED, JobState.RUNNING):
                        continue
                    if head is None:
                        head = j
                    if self._job_pending.get(j.job_id, 0) > 0:
                        jobs.append(j)
                if head is None:
                    return
                assignments = (self.policy.assign(jobs, self.rm, now)
                               if jobs else [])
                if not assignments:
                    assignments = self._try_preempt(head)
            else:
                if self._pending <= 0:
                    return      # nothing placeable; skip the job walk
                if self._pending_zero == 0 and self.rm.free_slots() <= 0:
                    return      # no slot anywhere, no slot-free work
                # lazy walk: jobs with no pending tasks are assignment
                # no-ops in every policy, so they are filtered out, and
                # early-exiting policies only consume the prefix they can
                # still place into
                job_pending = self._job_pending
                jobs_iter = (j for j in self.qm.iter_queued(now)
                             if j.state in (JobState.QUEUED, JobState.RUNNING)
                             and job_pending.get(j.job_id, 0) > 0)
                assignments = self.policy.assign(jobs_iter, self.rm, now)
        finally:
            # the hint is cycle-scoped; direct assign() callers (tests,
            # other engines reusing this policy object) must see None
            self.policy.zero_slot_backlog = None
        for task, nid in assignments:
            self._dispatch(task, nid, depth)
            depth -= 1

    # --------------------------------------------------------- dispatch
    def _dispatch(self, task: Task, node_id: int, queue_depth: int) -> None:
        now = self.loop.now
        c = self.profile.central_cost + self.profile.queue_coeff * queue_depth
        self.sched_clock = max(self.sched_clock, now) + c
        self.rm.allocate(task, node_id)
        if task.state in (TaskState.WAITING, TaskState.PREEMPTED):
            self._pending -= 1
            if task.request.slots <= 0:
                self._pending_zero -= 1
            self._job_pending[task.job_id] = \
                self._job_pending.get(task.job_id, 1) - 1
        task.state = TaskState.DISPATCHED
        task.dispatch_time = self.sched_clock
        task.attempts += 1
        self.dispatched += 1
        job = self._active_jobs.get(task.job_id)
        if job is not None and job.state is JobState.QUEUED:
            job.state = JobState.RUNNING
            st = self.stats[job.job_id]
            if st.first_dispatch == 0.0:
                st.first_dispatch = self.sched_clock
        start = self.sched_clock + self.profile.startup_cost
        task.start_time = start
        task.state = TaskState.RUNNING
        self._running_tasks[task.key] = task
        if self.on_dispatch is not None:
            self.on_dispatch(task, queue_depth)
        if self.executor is not None and task.payload is not None:
            self.loop.at(start, self._run_payload, task)
        else:
            dur = task.duration
            if self.rm._slow_nodes:
                slow = self.rm.nodes[node_id].slow
                if slow != 1.0:       # degraded node stretches the payload
                    dur = dur * slow
            self.loop.at(start + dur, self._finish_sim, task,
                         task.attempts)

    def _run_payload(self, task: Task) -> None:
        attempt = task.attempts

        def done(ok: bool) -> None:
            # same staleness guard as _finish_sim: the node may have failed
            # and the task re-dispatched while this payload was in flight
            if task.attempts == attempt:
                self._task_end(task, ok)

        self.executor.run(task, done)

    def _finish_sim(self, task: Task, attempt: int) -> None:
        """Virtual-duration completion, guarded by the dispatch attempt: a
        task requeued by a node failure (or preemption) and re-dispatched is
        RUNNING again when the *stale* pre-failure completion event fires —
        without the guard that event would finish the restarted work early."""
        if task.attempts == attempt:
            self._task_end(task, True)

    # ------------------------------------------------------- completion
    def _task_end(self, task: Task, ok: bool) -> None:
        if task.state is not TaskState.RUNNING:
            return  # cancelled / preempted / node already failed
        now = self.loop.now
        nid = task.node_id
        if self.rm._hidden_dead and nid is not None \
                and not self.rm.nodes[nid].alive:
            # the node died silently mid-run: this completion never happens.
            # The task stays RUNNING (its lease apparently live) until a
            # heartbeat sweep detects the lapse and requeues it — detection
            # latency, not an oracle.  The wave drain applies the same
            # suppression so both paths stay bit-identical.
            return
        task.end_time = now
        task.state = TaskState.COMPLETED if ok else TaskState.FAILED
        self._running_tasks.pop(task.key, None)
        self.rm.release(task)
        if self._fast and task.request.slots == 1 and nid is not None:
            self._free_stack.append(self.rm.nodes[nid])
        if self.config.heartbeat_interval > 0.0 and nid is not None:
            # task activity is a heartbeat: a completing node is a live node
            self.rm.nodes[nid].last_heartbeat = now
        self.sched_clock = max(self.sched_clock, now) + self.profile.completion_cost
        self.completed += 1
        self._durations.append(max(now - task.start_time, 1e-9))
        self._dur_version += 1
        if self.on_complete is not None:
            self.on_complete(task, ok)
        job = self._active_jobs.get(task.job_id)
        if job is None:
            return
        # speculative-clone resolution: first finisher wins
        clone = self._clones.pop(task.key, None)
        if clone is not None and clone is not task:
            self._cancel(clone)
        if task.speculative_of is not None:
            orig = job.tasks[task.speculative_of]
            self._clones.pop(orig.key, None)
            if orig.state is TaskState.RUNNING:
                self._cancel(orig)
            task_for_stats = orig
        else:
            task_for_stats = task
        permanent = False
        if ok:
            job.completed_tasks += 1
            self.stats[job.job_id].task_seconds += task.duration
        else:
            self.lost_work_s += max(now - task.start_time, 0.0)
            if task.attempts <= job.max_restarts:
                self._requeue_task(task, now)
            else:
                job.failed_tasks += 1
                permanent = True
        st = self.stats[job.job_id]
        st.last_end = max(st.last_end, now)
        if permanent and job.failure_policy == "fail_fast":
            self._fail_fast(job, now)
        elif job.done:
            self._retire(job, self._terminal_state(job), now)
        self._request_cycle()

    def _retire(self, job: Job, state: JobState, now: float) -> None:
        """Terminal bookkeeping: depth, fast-path counters, dependents."""
        if job.state in (JobState.QUEUED, JobState.RUNNING):
            self._depth -= job.n_tasks - self._cursor.get(job.job_id, 0)
            self._count_out(job)
        released = self.qm.job_finished(job, state, now)
        for dep in released:
            self._depth += dep.n_tasks - self._cursor.get(dep.job_id, 0)
            self._count_in(dep)
            if self.on_job_ready is not None:
                self.on_job_ready(dep)   # dependency release: now eligible
        if not self._unit.pop(job.job_id, True):
            self._nonunit -= 1
        self._cursor.pop(job.job_id, None)
        self._arena_jobs.discard(job.job_id)
        del self._active_jobs[job.job_id]
        if job._lo >= 0 and job._arena is not None:
            job._arena.release(job)
        if self.on_job_done is not None:
            self.on_job_done(job)

    def _cancel(self, task: Task) -> None:
        if task.state is TaskState.RUNNING:
            self._running_tasks.pop(task.key, None)
            self.rm.release(task)
            if self._fast and task.request.slots == 1 \
                    and task.node_id is not None:
                self._free_stack.append(self.rm.nodes[task.node_id])
        elif task.state in (TaskState.WAITING, TaskState.PREEMPTED):
            job = self._active_jobs.get(task.job_id)
            if job is not None and job.state in (JobState.QUEUED,
                                                 JobState.RUNNING):
                self._pending -= 1
                if task.request.slots <= 0:
                    self._pending_zero -= 1
                self._job_pending[task.job_id] = \
                    self._job_pending.get(task.job_id, 1) - 1
        task.state = TaskState.CANCELLED

    # --------------------------------------------- fault tolerance paths
    def _heartbeat_sweep(self) -> None:
        """Periodic heartbeat poll (``heartbeat_interval > 0``): stamp the
        responsive nodes, mark lapsed ones DOWN (which requeues their work
        via the down callback).  Re-arms itself while jobs are in flight;
        goes quiet when idle and is re-armed by the next ``submit``, so an
        idle engine's event loop can still drain."""
        self._sweep_armed = False
        newly_down = self.rm.sweep_heartbeats(self.loop.now)
        if self.on_sweep is not None:
            self.on_sweep(self.loop.now, newly_down)
        if self._active_jobs:
            self._sweep_armed = True
            self.loop.at(self.loop.now + self.config.heartbeat_interval,
                         self._heartbeat_sweep)

    def _requeue_task(self, task: Task, now: float) -> None:
        """Return a failed/orphaned attempt to the queue — immediately, or
        (``retry_backoff > 0``) only after an exponential-backoff delay in
        virtual time, during which the task is in BACKOFF limbo: invisible
        to every dispatch path and to the pending counters."""
        self.requeues += 1
        base = self.config.retry_backoff
        if base <= 0.0:
            task.state = TaskState.WAITING
            self._requeue.append(task)
            self._depth += 1
            self._count_requeued(task)
        else:
            delay = base * (2.0 ** (task.attempts - 1))
            cap = self.config.retry_backoff_cap
            if cap > 0.0 and delay > cap:
                delay = cap
            task.state = TaskState.BACKOFF
            task.backoff_until = now + delay
            self.loop.at(now + delay, self._backoff_ready, task, task.attempts)
        if self.on_requeue is not None:
            self.on_requeue(task, now)

    def _backoff_ready(self, task: Task, attempt: int) -> None:
        """Backoff expiry: make the task dispatch-eligible — unless the job
        retired or the task moved on (cancelled, quarantined) meanwhile."""
        if (task.state is not TaskState.BACKOFF or task.attempts != attempt
                or task.job_id not in self._active_jobs):
            return
        task.state = TaskState.WAITING
        self._requeue.append(task)
        self._depth += 1
        self._count_requeued(task)
        self._request_cycle()

    def _terminal_state(self, job: Job) -> JobState:
        """Job outcome under its failure policy (identical to the historical
        COMPLETED-iff-no-failures rule unless the policy says otherwise)."""
        if job.failed_tasks == 0:
            return JobState.COMPLETED
        if job.failure_policy == "best_effort" and job.completed_tasks > 0:
            return JobState.COMPLETED
        return JobState.FAILED

    def _fail_fast(self, job: Job, now: float) -> None:
        """fail_fast policy: a permanent task failure kills the whole job —
        cancel every non-terminal sibling (running work counts as lost) and
        retire FAILED immediately."""
        for t in job.tasks:
            ts = t.state
            if ts is TaskState.RUNNING:
                self.lost_work_s += max(now - t.start_time, 0.0)
                self._cancel(t)
            elif ts in (TaskState.WAITING, TaskState.PREEMPTED,
                        TaskState.BACKOFF, TaskState.DISPATCHED):
                self._cancel(t)
        self._retire(job, JobState.FAILED, now)

    def _lost_attempt(self, task: Task, job: Job, now: float) -> bool:
        """Close the books on a RUNNING attempt whose node or lease died:
        lost-work accounting, fault-hit count, then quarantine / requeue /
        permanent failure.  The caller has already released resources.
        Returns True when the loss was permanent (the job's books changed
        and its terminal policy must be re-checked)."""
        self.lost_work_s += max(now - task.start_time, 0.0)
        task.node_id = None
        hits = task.fault_hits + 1
        task.fault_hits = hits
        quarantine_after = self.config.quarantine_after
        if quarantine_after and hits >= quarantine_after:
            # poison task: its attempts keep coinciding with node
            # deaths — take it out of rotation regardless of budget
            task.state = TaskState.QUARANTINED
            self.quarantined += 1
            job.failed_tasks += 1
            if self.on_quarantine is not None:
                self.on_quarantine(task, now)
            return True
        if task.attempts <= job.max_restarts:
            self._requeue_task(task, now)
            return False
        task.state = TaskState.FAILED
        job.failed_tasks += 1
        return True

    def reclaim_task(self, task: Task,
                     attempt: Optional[int] = None) -> bool:
        """Reclaim a RUNNING attempt whose *lease* expired (the wall-clock
        runtime: missed lease renewals on a still-UP node, a lease message
        lost in transit, a worker that restarted without its old leases).

        Feeds the exact node-death path: resources released, lost work
        accounted, fault-hit counted (a reclaim is a fault-coincident loss,
        so poison tasks still quarantine), then retry budget / exponential
        backoff / job failure policy.  ``attempt`` fences stale reclaims:
        if given and the task has since moved on, this is a no-op.
        Returns True when the attempt was actually reclaimed.
        """
        if self._span or self._arena_q or self._arena_waves:
            self._exit_span()      # lease machinery needs object state
        if task.state is not TaskState.RUNNING:
            return False
        if attempt is not None and task.attempts != attempt:
            return False
        now = self.loop.now
        job = self._active_jobs.get(task.job_id)
        self._running_tasks.pop(task.key, None)
        nid = task.node_id
        self.rm.release(task)
        if self._fast and task.request.slots == 1 and nid is not None:
            node = self.rm.nodes[nid]
            if node.state is NodeState.UP:
                self._free_stack.append(node)
        if job is None:
            task.node_id = None
            return True
        if self._lost_attempt(task, job, now) \
                and job.job_id in self._active_jobs:
            if job.failure_policy == "fail_fast":
                self._fail_fast(job, now)
            elif job.done:
                self._retire(job, self._terminal_state(job), now)
        self._request_cycle()
        return True

    def _node_down(self, node_id: int) -> None:
        """Requeue orphaned tasks of a failed node (job restarting §3.2.7).

        Scans the running-task index, not every task of every job.  The
        failed node's free-stack entries are NOT filtered out here: both
        dispatch paths and _pop_free_node validate entries against live
        node state before use, so stale entries die lazily — an O(1)
        failure instead of an O(stack) rebuild per failure.
        """
        now = self.loop.now
        touched: List[Job] = []
        for t in list(self._running_tasks.values()):
            if t.node_id != node_id:
                continue
            job = self._active_jobs.get(t.job_id)
            if job is None:
                continue
            self._running_tasks.pop(t.key, None)
            # return consumables: the node's slot bookkeeping was reset when
            # it went down, but licenses are cluster-global and would leak
            # (release is a no-op on the node side: task.key was cleared
            # from node.running)
            self.rm.release(t)
            if self._lost_attempt(t, job, now):
                touched.append(job)
        for job in touched:
            # the failed task may have been the job's last outstanding one
            if job.job_id not in self._active_jobs:
                continue
            if job.failure_policy == "fail_fast":
                self._fail_fast(job, now)
            elif job.done:
                self._retire(job, self._terminal_state(job), now)
        self._request_cycle()

    def _node_up(self, node_id: int) -> None:
        """A rejoined node is fresh capacity: without a wake-up, work
        blocked on the lost capacity (e.g. a gang job) would stall forever
        once the event loop drains."""
        if self._fast:
            node = self.rm.nodes[node_id]
            self._free_stack.extend([node] * node.free_slots)
        if self._active_jobs:
            self._request_cycle()

    def fail_node(self, node_id: int) -> None:
        self.rm.mark_down(node_id)

    def _speculate(self) -> None:
        """Straggler mitigation: clone tasks running far beyond the median.

        Walks the running-task index (bounded by occupied slots) instead of
        every task of every active job.
        """
        if len(self._durations) < 8 or not self._free_stack:
            return
        # amortized median: recompute only when a completion changed the
        # durations window since the last check
        if self._med_version != self._dur_version:
            self._med_value = statistics.median(self._durations)
            self._med_version = self._dur_version
        med = self._med_value
        thresh = self.config.speculative_factor * med
        now = self.loop.now
        for t in list(self._running_tasks.values()):
            if not self._free_stack:
                break
            if (t.state is TaskState.RUNNING and t.speculative_of is None
                    and t.key not in self._clones
                    and now - t.start_time > thresh):
                job = self._active_jobs.get(t.job_id)
                if job is None:
                    continue
                nid = self._pop_free_node()
                if nid is None:
                    break       # only stale stack entries left
                clone = Task(job_id=t.job_id, index=len(job.tasks),
                             duration=t.duration, payload=t.payload,
                             request=t.request, speculative_of=t.index)
                job.tasks.append(clone)
                job.n_clones += 1
                if job.state in (JobState.QUEUED, JobState.RUNNING):
                    self._depth += 1     # clone extends the job's task span
                    self._count_requeued(clone)  # WAITING until dispatched
                self._clones[t.key] = clone
                self._dispatch(clone, nid, self._queue_depth())

    def _try_preempt(self, job: Job) -> List[Tuple[Task, int]]:
        """Preempt lowest-priority running tasks to fit `job` (§3.2.7)."""
        victims = sorted(
            (j for j in self._active_jobs.values()
             if j.state is JobState.RUNNING and j.priority < job.priority),
            key=lambda j: j.priority)
        freed = 0
        need = sum(t.request.slots for t in job.pending_tasks())
        for v in victims:
            for t in v.tasks:
                if t.state is TaskState.RUNNING:
                    remaining = max(t.duration - (self.loop.now - t.start_time), 0.0)
                    t.duration = remaining      # hibernate: resume remainder
                    self._running_tasks.pop(t.key, None)
                    self.rm.release(t)
                    t.state = TaskState.PREEMPTED
                    t.node_id = None
                    self._requeue.append(t)
                    self._depth += 1
                    self._count_requeued(t)
                    freed += t.request.slots
                if freed >= need:
                    break
            if freed >= need:
                break
        if freed < need:
            return []
        return self.policy.assign([job], self.rm, self.loop.now)

    # ------------------------------------------------------------- run
    def run(self, until: float = float("inf")) -> None:
        self.loop.run(until)

    @property
    def active_jobs(self) -> int:
        """Jobs submitted and not yet retired (materialized working set)."""
        return len(self._active_jobs)

    # ------------------------------------------------------------ stats
    def utilization(self, job_ids: Optional[List[int]] = None) -> float:
        """U = T_job / T_total over the given jobs (paper §4)."""
        sts = [self.stats[j] for j in (job_ids or list(self.stats))]
        if not sts:
            return 0.0
        slots = self.rm.total_slots() or 1
        t0 = min(s.submit_time for s in sts)
        t1 = max(s.last_end for s in sts)
        span = max(t1 - t0, 1e-12)
        busy = sum(s.task_seconds for s in sts)
        return busy / (slots * span)


class Executor:
    """Real-execution backend interface (see core/executor.py)."""

    def run(self, task: Task, done: Callable[[bool], None]) -> None:
        raise NotImplementedError

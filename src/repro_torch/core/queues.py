"""Queue management (paper §3.2.2): multiple queues, priorities, fair-share.

Each queue orders its eligible jobs by an effective priority combining the
job's static priority, submit order (FCFS tiebreak), and a decayed fair-share
usage penalty per user (§3.2.5 prioritization schema).

Hot-path design (control-plane scalability): the seed implementation re-sorted
every queue on every task fetch — O(J log J) per dispatch — which collapses
throughput in the many-jobs regime the paper targets (Byun et al. 2021).  This
version keeps:

  * a lazy-deletion heap per queue keyed on effective priority, so the best
    job is an O(log J) pop instead of a full sort;
  * a global dispatch-order heap in ``QueueManager`` with an iterator-style
    ``next_eligible()`` API, so the scheduler's task fetch is amortized O(1);
  * a reverse-dependency index, so finishing a job releases its dependents in
    O(dependents) instead of scanning every job ever submitted;
  * a per-user lazily-decayed ``FairShareLedger`` (exponential decay is
    memoryless, so decaying on touch is exact), instead of O(users) per call.

``ordered()``/``queued_jobs()`` are kept for compatibility and for golden
tests: they recompute the seed's exact sort so the heap path can be checked
against it.

A copy of the reference's ``repro/core/queues.py``; test files named
below are the reference's, and ``tests/test_torch_scheduler.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

import bisect
import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.job import Job, JobState, Task, TaskState


@dataclass
class QueueConfig:
    name: str = "default"
    priority: float = 0.0          # queue-level priority boost
    max_slots: int = 0             # 0 = unlimited
    fair_share: bool = False
    fair_share_halflife: float = 3600.0


class FairShareLedger:
    """Exponentially-decayed per-user usage (slot-seconds).

    Decay is applied lazily per user on touch: exponential decay is
    memoryless, so ``u(t) = u(t0) * 0.5^((t-t0)/halflife)`` gives exactly the
    same value as the seed's eager O(users) sweep, at O(1) per call.
    ``version`` increments whenever recorded usage changes so heap-backed
    queues know when cached effective-priority keys are stale.
    """

    def __init__(self, halflife: float):
        self.halflife = halflife
        self.usage: Dict[str, float] = {}    # value as of _last[user]
        self._last: Dict[str, float] = {}
        self.version = 0

    def record(self, user: str, slot_seconds: float, now: float) -> None:
        self.usage[user] = self._current(user, now) + slot_seconds
        self._last[user] = now
        self.version += 1

    def penalty(self, user: str, now: float) -> float:
        return math.log1p(self._current(user, now))

    def _current(self, user: str, now: float) -> float:
        u = self.usage.get(user, 0.0)
        if u == 0.0:
            return 0.0
        dt = now - self._last.get(user, now)
        if dt <= 0:
            return u
        return u * 0.5 ** (dt / self.halflife)


class JobQueue:
    """A named queue backed by a lazy-deletion heap on effective priority.

    The heap itself is built lazily on the first per-queue fetch: the
    scheduler's FIFO fast path fetches through the QueueManager's global
    dispatch-order heap and never touches it, so pure fast-path runs skip
    the per-push effective-key/heappush work entirely (the many-short-jobs
    regime submits and retires thousands of queues' worth of jobs without
    ever needing a per-queue priority view).
    """

    def __init__(self, config: Optional[QueueConfig] = None):
        self.config = config or QueueConfig()
        self.ledger = FairShareLedger(self.config.fair_share_halflife)
        self.slots_in_use = 0
        self._members: Dict[int, Job] = {}   # job_id -> Job, insertion order
        self._heap: List[Tuple[Tuple[float, float, int], int, Job]] = []
        self._heap_live = False              # built on first next_eligible
        self._seq = itertools.count()
        self._ledger_version = 0
        self._rekey_now: Optional[float] = None
        self._dead = 0                       # lazily-deleted entries in _heap

    # compatibility view: the seed exposed a plain list
    @property
    def jobs(self) -> List[Job]:
        return list(self._members.values())

    def effective_key(self, job: Job, now: float) -> Tuple[float, float, int]:
        eff = job.priority + self.config.priority
        if self.config.fair_share:
            eff -= self.ledger.penalty(job.user, now)
        return (-eff, job.submit_time, job.job_id)

    def push(self, job: Job, now: float = 0.0) -> None:
        job.state = JobState.QUEUED
        self._members[job.job_id] = job
        if self._heap_live:
            heapq.heappush(
                self._heap, (self.effective_key(job, now), next(self._seq), job))

    def remove(self, job: Job) -> None:
        # heap entry dies lazily; membership is the source of truth
        if (self._members.pop(job.job_id, None) is not None
                and self._heap_live):
            self._dead += 1
            # compaction keeps each live entry's original key: identical
            # lazy-deletion semantics, amortized O(1) per removal, and a
            # retired job's task graph never stays pinned here.
            if self._dead > 16 and self._dead > len(self._members):
                self._heap = [e for e in self._heap
                              if self._members.get(e[2].job_id) is e[2]]
                heapq.heapify(self._heap)
                self._dead = 0

    def __contains__(self, job: Job) -> bool:
        return self._members.get(job.job_id) is job

    def ordered(self, now: float) -> List[Job]:
        """Jobs by descending effective priority, FCFS within ties.

        Exact seed semantics (recomputes every key live); O(J log J) — kept
        for compatibility and as the golden reference for the heap path.
        """
        return sorted(self._members.values(),
                      key=lambda j: self.effective_key(j, now))

    def next_eligible(self, now: float) -> Optional[Job]:
        """Highest-effective-priority member.

        Amortized O(log J) without fair-share (keys are static). With
        fair-share and recorded usage, keys drift with the decay clock, so
        the heap is re-keyed (O(J) heapify) whenever usage was recorded or
        ``now`` moved since the last call — mixing keys computed at
        different timestamps is not order-safe. Still cheaper than the
        seed's O(J log J) sort per fetch, and exact: matches ``ordered()``.
        """
        if not self._heap_live:
            self._heap_live = True
            self._rekey(now)
        elif (self.config.fair_share and self.ledger.usage
                and (self.ledger.version != self._ledger_version
                     or self._rekey_now != now)):
            self._rekey(now)
        while self._heap:
            _, _, job = self._heap[0]
            if self._members.get(job.job_id) is not job:
                heapq.heappop(self._heap)       # lazily drop removed jobs
                if self._dead > 0:
                    self._dead -= 1
                continue
            return job
        return None

    def _rekey(self, now: float) -> None:
        self._ledger_version = self.ledger.version
        self._rekey_now = now
        self._heap = [(self.effective_key(j, now), i, j)
                      for i, j in enumerate(self._members.values())]
        heapq.heapify(self._heap)
        self._dead = 0

    def over_limit(self, extra_slots: int) -> bool:
        return (self.config.max_slots > 0
                and self.slots_in_use + extra_slots > self.config.max_slots)

    def __len__(self) -> int:
        return len(self._members)


def _global_key(job: Job) -> Tuple[float, float, int]:
    """The scheduler-wide dispatch order (seed's final ``queued_jobs`` sort).

    The key is total (job_id is unique) and static for a queued job, which is
    what makes a no-rekey heap exact for the global fetch path.
    """
    return (-job.priority, job.submit_time, job.job_id)


class QueueManager:
    """Named queues + DAG dependency gating (PENDING -> QUEUED).

    Maintains a global lazy-deletion heap over all queued jobs in dispatch
    order, plus a reverse-dependency index (dep job id -> pending dependents)
    so job completion releases dependents without scanning history.
    """

    def __init__(self):
        self.queues: Dict[str, JobQueue] = {"default": JobQueue()}
        self.jobs: Dict[int, Job] = {}
        self._finished: Dict[int, JobState] = {}
        self._order_heap: List[Tuple[Tuple[float, float, int], int, Job]] = []
        self._order_dead = 0                 # dequeued entries still in heap
        self._seq = itertools.count()
        self._queued: Set[int] = set()       # job ids currently in some queue
        self._exhausted: Set[int] = set()    # ids with no unfetched tasks
        self._waiting_on: Dict[int, Set[int]] = {}   # pending -> unmet deps
        self._dependents: Dict[int, List[Job]] = {}  # dep -> pending waiters
        # dispatch-order snapshot for the policy path: sorted-insert on
        # enqueue, lazy-deletion on dequeue, built on first use so pure
        # fast-path (FIFO) runs never pay for it
        self._ordered: Optional[List[Tuple[Tuple[float, float, int], Job]]] = None
        self._ordered_dead = 0

    def add_queue(self, config: QueueConfig) -> None:
        self.queues[config.name] = JobQueue(config)

    # ------------------------------------------------------------ submit
    def submit(self, job: Job, now: float, stamp_tasks: bool = True) -> None:
        """Register and (if eligible) enqueue ``job``.

        ``stamp_tasks=False`` skips the per-task submit-time stamping for
        callers that already stamped during their own admission walk (the
        scheduler fuses it with its unit/pending-count pass).
        """
        job.submit_time = now
        if stamp_tasks:
            for t in job.tasks:
                t.submit_time = now
        self.jobs[job.job_id] = job
        if not job.depends_on:           # hot path: no dependency gating
            self._enqueue(job, now)
            return
        unmet = {d for d in job.depends_on
                 if self._finished.get(d) is not JobState.COMPLETED}
        if not unmet:
            self._enqueue(job, now)
        else:
            job.state = JobState.PENDING
            self._waiting_on[job.job_id] = unmet
            for d in unmet:
                self._dependents.setdefault(d, []).append(job)

    def _enqueue(self, job: Job, now: float) -> None:
        q = self.queues.get(job.queue)
        if q is None:                    # setdefault would build (and drop)
            q = self.queues[job.queue] = JobQueue()  # a JobQueue per call
        q.push(job, now)
        self._queued.add(job.job_id)
        heapq.heappush(self._order_heap,
                       (_global_key(job), next(self._seq), job))
        if self._ordered is not None:
            # keys are total (job_id breaks ties), so Job never compares
            bisect.insort(self._ordered, (_global_key(job), job))

    def adopt(self, job: Job, now: float) -> None:
        """Register a job the scheduler admitted outside the manager (the
        arena fast lane) without disturbing its state or submit stamp.

        Exactly ``submit`` minus stamping and dependency gating: arena-lane
        jobs are dependency-free and already QUEUED/RUNNING; ``push`` sets
        QUEUED unconditionally, so the caller's state is restored around it.
        """
        self.jobs[job.job_id] = job
        state = job.state
        self._enqueue(job, now)
        job.state = state

    def _deps_met(self, job: Job) -> bool:
        return all(self._finished.get(d) == JobState.COMPLETED
                   for d in job.depends_on)

    # ------------------------------------------------------- termination
    def dequeue(self, job: Job) -> bool:
        """Drop a job from its queue (heap entries die lazily)."""
        was_queued = job.job_id in self._queued
        self._queued.discard(job.job_id)
        self._exhausted.discard(job.job_id)
        q = self.queues.get(job.queue)
        if q is not None:
            q.remove(job)
        if was_queued:
            if self._ordered is not None:
                self._ordered_dead += 1  # entry dies lazily
            # policy-path runs fetch through iter_queued and never pop this
            # heap, so dead entries (each pinning a Job/Task graph) must be
            # compacted here or a streamed run retains the whole trace
            self._order_dead += 1
            if (self._order_dead > 16
                    and self._order_dead > len(self._queued)):
                self._order_heap = [e for e in self._order_heap
                                    if e[2].job_id in self._queued]
                heapq.heapify(self._order_heap)
                self._order_dead = 0
        return was_queued

    def job_finished(self, job: Job, state: JobState, now: float) -> List[Job]:
        """Record terminal state; release newly-eligible dependents.

        O(direct dependents) via the reverse index — a dependent is released
        once its unmet-dependency set drains (only COMPLETED satisfies a
        dependency, exactly as the seed's ``_deps_met``).
        """
        self._finished[job.job_id] = state
        job.state = state
        job.end_time = now
        self.dequeue(job)
        # the registry holds live jobs only: a retired job's entry (and with
        # it the Job/Task graph) must be collectible, or a million-job
        # streamed run retains every task ever submitted. Terminal state
        # survives in _finished (ids only) for dependency gating.
        self.jobs.pop(job.job_id, None)
        released: List[Job] = []
        waiters = self._dependents.pop(job.job_id, ())
        if state is JobState.COMPLETED:
            for dep in waiters:
                unmet = self._waiting_on.get(dep.job_id)
                if unmet is None or dep.state is not JobState.PENDING:
                    continue
                unmet.discard(job.job_id)
                if not unmet:
                    del self._waiting_on[dep.job_id]
                    self._enqueue(dep, now)
                    released.append(dep)
        # a FAILED/CANCELLED dependency can never be satisfied again, so its
        # waiters stay PENDING forever (seed semantics); the index entry is
        # dropped either way.
        return released

    # ---------------------------------------------------------- fetching
    def next_eligible(self) -> Optional[Job]:
        """Best queued job in dispatch order, skipping exhausted jobs.

        Amortized O(1): each heap entry is pushed once and popped at most
        once; the scheduler marks jobs exhausted when their task cursor runs
        out (requeued tasks re-enter via the scheduler's requeue lane, never
        through this path).
        """
        h = self._order_heap
        while h:
            _, _, job = h[0]
            if job.job_id not in self._queued:
                heapq.heappop(h)
                if self._order_dead > 0:
                    self._order_dead -= 1
                continue
            if job.job_id in self._exhausted:
                heapq.heappop(h)
                continue
            return job
        return None

    def mark_exhausted(self, job_id: int) -> None:
        self._exhausted.add(job_id)

    def take_waiting(self, cursor: Dict[int, int], k: int
                     ) -> Tuple[List[Task], List[Tuple[Job, int]],
                                Optional[List[int]], int]:
        """Bulk task fetch for the wave path: up to ``k`` WAITING tasks.

        Walks eligible jobs in dispatch order, advancing the scheduler's
        per-job ``cursor`` over each job's task list in contiguous slices —
        one list-extend per (job, run) instead of one full fetch cycle per
        task.  Returns ``(tasks, groups, skips, consumed)``:

        * ``groups`` — ``(job, count)`` runs, in task order, so the caller
          does per-job bookkeeping (state transition, pending counters)
          once per run instead of once per task;
        * ``skips`` — per-task count of non-WAITING cursor entries consumed
          before that task (``None`` when there were none): the latency
          model charges a queue depth that such entries decrement, so the
          closed-form depth recurrence needs them;
        * ``consumed`` — total cursor advancement (tasks + skipped entries),
          i.e. the caller's queue-depth decrement.

        Equivalent, task for task, to repeated single fetches through
        ``next_eligible()`` + cursor walk (the per-event path's loop).
        """
        tasks: List[Task] = []
        groups: List[Tuple[Job, int]] = []
        skips: Optional[List[int]] = None
        extra = 0
        consumed = 0
        WAITING = TaskState.WAITING
        while len(tasks) < k:
            job = self.next_eligible()
            if job is None:
                break
            jid = job.job_id
            cur = cursor.get(jid, 0)
            jt = job.tasks
            n = len(jt)
            if cur >= n:
                self.mark_exhausted(jid)   # requeues bypass this path
                continue
            take = k - len(tasks)
            if take > n - cur:
                take = n - cur
            seg = jt[cur:cur + take]
            got = take
            for j, t in enumerate(seg):
                if t.state is not WAITING:
                    got = j
                    break
            if got:
                tasks.extend(seg if got == take else seg[:got])
                groups.append((job, got))
                if skips is not None:
                    skips.extend([extra] * got)
                consumed += got
                cur += got
            if got < take:
                # a non-WAITING entry: consume it (depth decrements) and
                # keep walking, exactly like the per-event cursor loop
                if skips is None:
                    skips = [0] * len(tasks)
                extra += 1
                consumed += 1
                cur += 1
            cursor[jid] = cur
        return tasks, groups, skips, consumed

    def _refresh_ordered(self) -> None:
        """Build the snapshot on first use; compact once dead entries
        outnumber live ones, keeping walks linear in *live* jobs."""
        if self._ordered is None:
            self._ordered = sorted(
                (_global_key(j), j) for q in self.queues.values()
                for j in q._members.values())
            self._ordered_dead = 0
        elif self._ordered_dead * 2 > len(self._ordered):
            self._ordered = [e for e in self._ordered
                             if e[1].job_id in self._queued]
            self._ordered_dead = 0

    def queued_jobs(self, now: float) -> List[Job]:
        """All eligible jobs across queues in dispatch order (seed-exact).

        Served from the incrementally-sorted snapshot: O(live + dead) per
        call instead of the seed's O(J log J) re-sort.
        """
        return list(self.iter_queued(now))

    def iter_queued(self, now: float):
        """Lazy ``queued_jobs``: yields in dispatch order, so early-exiting
        consumers (the policy cycle once capacity is exhausted) pay only
        for the prefix they actually look at."""
        self._refresh_ordered()
        queued = self._queued
        for _, j in self._ordered:
            if j.job_id in queued:
                yield j

    def depth(self) -> int:
        return sum(len(q) for q in self.queues.values())

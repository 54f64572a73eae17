"""Struct-of-arrays task arena: the million-tasks/s control-plane backing.

The paper's thesis (and our own self-measurement, ``benchmarks/
self_latency.py``) is that scheduler marginal latency bounds utilization;
after PR 5's wave batching the remaining control-plane cost was per-task
Python object lifecycle — building, stamping, and collecting one ``Task``
per dispatch.  Byun et al. ("Node-Based Job Scheduling for Large Scale
Simulations of Short Running Jobs") scale short-job scheduling by removing
per-task work entirely; this module is that move for our engine.

Slab layout
-----------
Task ids are allocated contiguously per job (``alloc`` reserves
``[job._lo, job._lo + n)`` at the job's first dispatch; jobs are consumed
FIFO on the arena lane, so a job's ids are always one dense range).  The
arena stores four parallel slabs, chunked in ``CHUNK``-sized numpy blocks
so a streamed run's retired chunks can be recycled:

  ``dispatch_t``  float64   serial-clock dispatch stamp
  ``end_t``       float64   completion stamp (valid when state==COMPLETED)
  ``node_id``     int32     placement
  ``state``       uint8     0 unwritten, 1 RUNNING, 2 COMPLETED

``start_time`` is not stored: it is always ``dispatch_t + startup_cost``
and the recomputation reproduces the engine's float op exactly (one IEEE
double add).  ``attempts`` is not stored: the arena fast lane is only
active while no fault machinery is (the scheduler exits the lane before
any node state change), so every arena-dispatched attempt is attempt 1.
``submit_time`` is job-level.  Slabs are written only at wave retirement
or span exit — a handful of slice writes per wave, not per task.

View-materialization contract
-----------------------------
``Job``/``Task`` objects become *views*: ``Job.array`` records a compact
spec and the ``tasks`` property materializes on first access through
``materialize_job``.  The contract:

* observers, the per-event fallback, the policy path, and the fault/rt
  planes always see fully materialized jobs — the scheduler exits the
  arena span (``Scheduler._exit_span``) before any of them can run, which
  flushes in-flight waves to the slabs and builds views for every job the
  span still owned;
* materializing while the scheduler holds arena residue (an active span,
  undrained arena waves, or a queued arena backlog) triggers that same
  span exit first, so a view is never built from a slab a live wave has
  not yet written;
* a retired job's views are built directly from the slabs, with exactly
  the field values the object path would have left: COMPLETED tasks carry
  (dispatch, start, end, node_id, attempts=1), RUNNING tasks the same
  minus ``end_time``, unfetched tasks are fresh WAITING;
* with ``recycle`` enabled (bounded-memory streaming), a chunk whose jobs
  all retired is dropped; materializing a job whose slab was recycled is a
  ``RuntimeError`` (the caller opted out of replay, not a silent zero).

``materialized_jobs`` counts view builds so memory-bound tests can assert
that a streamed run materializes O(active) jobs, not O(trace).

A copy of the reference's ``repro/core/arena.py``; test files named
below are the reference's, and ``tests/test_torch_scheduler.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

from repro_torch.core.job import Job, Task, TaskState

CHUNK_BITS = 15
CHUNK = 1 << CHUNK_BITS
_MASK = CHUNK - 1


class Arena:
    """Chunked struct-of-arrays slabs + view materialization for Jobs."""

    def __init__(self, startup_cost: float, recycle: bool = False):
        self._su = startup_cost
        self.recycle = recycle
        self._n = 0                       # high-water task id
        self._disp: Dict[int, np.ndarray] = {}
        self._end: Dict[int, np.ndarray] = {}
        self._node: Dict[int, np.ndarray] = {}
        self._state: Dict[int, np.ndarray] = {}
        self._refs: Dict[int, int] = {}   # chunk -> live (unretired) jobs
        self._freed: Set[int] = set()     # recycled chunk ids
        self._sch = None                  # owning Scheduler (span exits)
        self.materialized_jobs = 0        # view builds (memory acceptance)

    # ------------------------------------------------------- allocation
    def alloc(self, job: Job, n: int) -> int:
        """Reserve a contiguous task-id range for ``job``'s n tasks."""
        lo = self._n
        self._n = lo + n
        if n > 0:
            refs = self._refs
            for c in range(lo >> CHUNK_BITS, (lo + n - 1 >> CHUNK_BITS) + 1):
                if c not in self._disp:
                    self._disp[c] = np.empty(CHUNK, dtype=np.float64)
                    self._end[c] = np.empty(CHUNK, dtype=np.float64)
                    self._node[c] = np.empty(CHUNK, dtype=np.int32)
                    self._state[c] = np.zeros(CHUNK, dtype=np.uint8)
                refs[c] = refs.get(c, 0) + 1
        job._arena = self
        job._lo = lo
        return lo

    def release(self, job: Job) -> None:
        """A job retired: drop its chunk refs (recycling frees the slab)."""
        lo = job._lo
        n = job.n_tasks
        if lo < 0 or n <= 0:
            return
        refs = self._refs
        for c in range(lo >> CHUNK_BITS, (lo + n - 1 >> CHUNK_BITS) + 1):
            r = refs.get(c, 0) - 1
            refs[c] = r
            if r <= 0 and self.recycle:
                del refs[c]
                self._disp.pop(c, None)
                self._end.pop(c, None)
                self._node.pop(c, None)
                self._state.pop(c, None)
                self._freed.add(c)

    def release_span(self) -> None:
        """Bulk retire: every ref-holding job finished at once (span burst).

        End state is identical to calling :meth:`release` once per live
        job — all chunk refcounts reach zero, and with recycling on every
        resident chunk is freed in one sweep instead of per-job ref
        arithmetic."""
        refs = self._refs
        if self.recycle:
            self._freed.update(self._disp)
            self._disp.clear()
            self._end.clear()
            self._node.clear()
            self._state.clear()
            refs.clear()
        else:
            for c in refs:
                refs[c] = 0

    # ------------------------------------------------------ slab writes
    def write_run(self, tid0: int, clocks, ends, nids, states) -> None:
        """Write one dispatched run's slab entries (inputs in task order;
        ``states`` is a scalar or a per-task array)."""
        n = len(clocks)
        scalar = isinstance(states, int)
        pos = 0
        while pos < n:
            tid = tid0 + pos
            c = tid >> CHUNK_BITS
            o = tid & _MASK
            take = CHUNK - o
            if take > n - pos:
                take = n - pos
            end = pos + take
            if c not in self._disp:
                pos = end      # chunk recycled (job already retired): skip
                continue
            self._disp[c][o:o + take] = clocks[pos:end]
            self._end[c][o:o + take] = ends[pos:end]
            self._node[c][o:o + take] = nids[pos:end]
            self._state[c][o:o + take] = states if scalar else states[pos:end]
            pos = end

    # ------------------------------------------------- materialization
    def materialize_job(self, job: Job) -> List[Task]:
        """Build ``job``'s Task views (the ``Job.tasks`` property's arena
        path).  Exits the owning scheduler's span first when it holds arena
        residue, so slabs are complete before any view is built."""
        sch = self._sch
        if sch is not None and (sch._span or sch._arena_waves
                                or sch._arena_q):
            sch._exit_span()
            if job._tasks is not None:
                return job._tasks
        return self._build_tasks(job)

    def _build_tasks(self, job: Job) -> List[Task]:
        """Materialize directly from the slabs (no span interaction)."""
        n, duration, durations, req = job._lazy
        jid = job.job_id
        lo = job._lo
        filled = job._filled if lo >= 0 else 0
        sub = job.submit_time
        su = self._su
        tasks: List[Task] = []
        app = tasks.append
        if filled:
            for c in range(lo >> CHUNK_BITS,
                           (lo + filled - 1 >> CHUNK_BITS) + 1):
                if c in self._freed:
                    raise RuntimeError(
                        f"job {jid}: task slab chunk {c} was recycled "
                        "(Arena.recycle is on); materialization after "
                        "retirement is unavailable in bounded-memory mode")
            COMPLETED = TaskState.COMPLETED
            RUNNING = TaskState.RUNNING
            for i in range(filled):
                tid = lo + i
                c = tid >> CHUNK_BITS
                o = tid & _MASK
                t = Task(jid, i,
                         durations[i] if durations is not None else duration,
                         None, req)
                if sub:
                    t.submit_time = sub
                disp = float(self._disp[c][o])
                t.dispatch_time = disp
                t.start_time = disp + su
                t.node_id = int(self._node[c][o])
                t.attempts = 1
                if self._state[c][o] == 2:
                    t.state = COMPLETED
                    t.end_time = float(self._end[c][o])
                else:
                    t.state = RUNNING
                app(t)
        for i in range(filled, n):
            t = Task(jid, i,
                     durations[i] if durations is not None else duration,
                     None, req)
            if sub:
                t.submit_time = sub
            app(t)
        job._tasks = tasks
        self.materialized_jobs += 1
        return tasks

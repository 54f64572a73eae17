"""Flight recorder: bounded ring-buffer event trace of the task lifecycle.

Every event is one uniform 6-tuple ``(t, kind, job, task, node, aux)``
(``-1`` where a field does not apply), appended to a ``deque(maxlen=...)``
— a 1M-task run records in O(1) amortized per event and bounded memory,
the constraint Byun et al. put on instrumentation of short-job regimes.

Kinds and their fields:

=============  ======================================================
``submit``     job arrived (``aux`` = n_tasks)
``ready``      job became dispatch-eligible: at submit with no unmet
               dependencies, or on dependency release (``aux`` = n_tasks)
``cycle``      scheduling cycle entry (``aux`` = queue depth charged)
``dispatch``   task committed to ``node`` (``t`` = dispatch_time,
               ``aux`` = queue depth the latency model charged)
``complete``   task finished OK (``t`` = end_time, ``aux`` =
               dispatch_time, so the span needs no pairing scan)
``failed``     task attempt failed (same fields as ``complete``)
``requeue``    failed/orphaned attempt returned to the queue
               immediately (``aux`` = attempts so far)
``backoff``    ditto, but parked in exponential-backoff limbo first
``quarantine`` poison task permanently parked (``aux`` = attempts)
``job_done``   job retired (``aux`` = terminal JobState name)
``node_down``  / ``node_up`` / ``mute`` / ``unmute``: membership and
               false-positive transitions (``node`` set)
``sweep``      heartbeat sweep ran (``aux`` = nodes newly detected down)
``fault``      fault-plane injection delivered (``node`` = entity id,
               ``aux`` = event name, e.g. ``crash`` / ``domain_repair``)
=============  ======================================================

Bit-identity across dispatch paths: timestamps are task-intrinsic
(``dispatch_time`` / ``end_time``) or event-loop times at real events, so
the wave-batched engine — whose batch hook reconstructs per-task dispatches
exactly as ``MetricsTap._on_dispatch_batch`` does, and whose completion
drain fires ``on_complete`` in per-event order — produces the *identical*
event stream as the per-event engine (the reference's tests/test_obs.py
pins this differentially over the wavepath and fault-plane scenario
matrices, and runs against this copy through tests/test_torch_ref_obs.py).

Export: :meth:`FlightRecorder.export_chrome` writes Chrome-trace JSON
(``chrome://tracing`` / Perfetto): task spans as ``X`` duration events per
node row, queue depth as a ``C`` counter track, lifecycle/fault marks as
``i`` instants.

A copy of the reference's ``repro/obs/trace.py``; tests/test_torch_obs.py
holds its event streams and Chrome-trace exports equal to the reference's.
Under the wall-clock runtime (``repro_torch.rt``) the loop is pumped at
wall time, so event times are wall seconds since the runtime started; under
an executor in virtual time they are virtual seconds, and host stalls show
only in ``SelfProfiler``.
"""
from __future__ import annotations

import collections
import json
from typing import Dict, List, Tuple

from repro_torch.core.job import TaskState

Event = Tuple[float, str, int, int, int, object]

#: event kinds whose ``job`` field (index 2) is a live job id — used by
#: :meth:`FlightRecorder.events_normalized` (the global job-id counter
#: differs between runs, so differential tests remap by submission order)
_JOB_KINDS = frozenset((
    "submit", "ready", "dispatch", "complete", "failed",
    "requeue", "backoff", "quarantine", "job_done"))


class FlightRecorder:
    """Attach to a Scheduler (and optionally a FaultPlane); read ``events``.

    Chains behind any observer already installed (and is replay-safe in
    front of later per-task-only subscribers, mirroring ``MetricsTap``'s
    clobber-replay contract), so recorder + tap compose in either order.
    """

    def __init__(self, capacity: int = 1 << 20):
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.recorded = 0          # total ever; dropped = recorded - len()
        self._sch = None
        self._bound_dispatch = None
        self._bound_batch = None
        self._chain = {}           # hook attr -> prior subscriber

    @property
    def dropped(self) -> int:
        return self.recorded - len(self.events)

    # ------------------------------------------------------------ attach
    def attach(self, sch) -> "FlightRecorder":
        if self._sch is not None:
            raise RuntimeError("FlightRecorder is already attached; "
                               "use one recorder per scheduler")
        self._sch = sch
        # keep the exact bound-method identities installed (the batch hook
        # compares against them to detect per-task clobbering, exactly as
        # MetricsTap does)
        self._bound_dispatch = self._on_dispatch
        self._bound_batch = self._on_batch
        chain = self._chain
        for attr, hook in (
                ("on_submit", self._on_submit),
                ("on_job_ready", self._on_ready),
                ("on_cycle", self._on_cycle),
                ("on_dispatch", self._bound_dispatch),
                ("on_dispatch_batch", self._bound_batch),
                ("on_complete", self._on_complete),
                ("on_requeue", self._on_requeue),
                ("on_quarantine", self._on_quarantine),
                ("on_job_done", self._on_job_done),
                ("on_sweep", self._on_sweep)):
            chain[attr] = getattr(sch, attr)
            setattr(sch, attr, hook)
        rm = sch.rm
        rm.on_node_down(self._on_node_down)
        rm.on_node_up(self._on_node_up)
        rm.on_node_mute(self._on_node_mute)
        return self

    def attach_faults(self, plane) -> "FlightRecorder":
        """Also record a fault plane's delivered injections."""
        self._chain["faults.on_event"] = plane.on_event
        prior = plane.on_event

        def hook(t: float, kind: str, ent: int) -> None:
            self.recorded += 1
            self.events.append((t, "fault", -1, -1, ent, kind))
            if prior is not None:
                prior(t, kind, ent)

        plane.on_event = hook
        return self

    # ------------------------------------------------------------- hooks
    def _on_submit(self, job) -> None:
        self.recorded += 1
        self.events.append((self._sch.loop.now, "submit", job.job_id,
                            -1, -1, job.n_tasks))
        prior = self._chain["on_submit"]
        if prior is not None:
            prior(job)

    def _on_ready(self, job) -> None:
        self.recorded += 1
        self.events.append((self._sch.loop.now, "ready", job.job_id,
                            -1, -1, job.n_tasks))
        prior = self._chain["on_job_ready"]
        if prior is not None:
            prior(job)

    def _on_cycle(self, now: float, depth: int) -> None:
        self.recorded += 1
        self.events.append((now, "cycle", -1, -1, -1, depth))
        prior = self._chain["on_cycle"]
        if prior is not None:
            prior(now, depth)

    def _on_dispatch(self, task, depth: int) -> None:
        self.recorded += 1
        self.events.append((task.dispatch_time, "dispatch", task.job_id,
                            task.index, task.node_id, depth))
        prior = self._chain["on_dispatch"]
        if prior is not None:
            prior(task, depth)

    def _on_batch(self, tasks: List, depths: List[int]) -> None:
        """Wave-path observer: reconstruct per-task dispatch events.

        Timestamps are the tasks' own ``dispatch_time`` (the serial-clock
        instants the per-event path observes), so the recorded stream is
        bit-identical to per-event recording."""
        events = self.events
        n = len(tasks)
        self.recorded += n
        for i, task in enumerate(tasks):
            events.append((task.dispatch_time, "dispatch", task.job_id,
                           task.index, task.node_id, depths[i]))
        # per-task replay (same contract as MetricsTap._on_dispatch_batch):
        # attaching put the engine on the wave path, which never calls
        # on_dispatch — chained/clobbering per-task subscribers must be
        # replayed here or they silently observe nothing.
        sch = self._sch
        chained_batch = self._chain["on_dispatch_batch"]
        if chained_batch is not None:
            chained_batch(tasks, depths)
            replay = None               # inner observer replays its own chain
        else:
            replay = self._chain["on_dispatch"]
        cur = sch.on_dispatch
        if (sch.on_dispatch_batch is self._bound_batch
                and cur is not None and cur is not self._bound_dispatch):
            replay = cur                # later subscriber clobbered per-task
        if replay is not None:
            for i, task in enumerate(tasks):
                replay(task, depths[i])

    def _on_complete(self, task, ok: bool) -> None:
        # task-intrinsic timestamps only: inside the wave drain the loop
        # clock is deferred, but end_time/dispatch_time are exact
        self.recorded += 1
        self.events.append((task.end_time, "complete" if ok else "failed",
                            task.job_id, task.index, task.node_id,
                            task.dispatch_time))
        prior = self._chain["on_complete"]
        if prior is not None:
            prior(task, ok)

    def _on_requeue(self, task, now: float) -> None:
        # the scheduler stamps the state before firing: WAITING means an
        # immediate requeue, BACKOFF means exponential-backoff limbo
        kind = "backoff" if task.state is TaskState.BACKOFF else "requeue"
        nid = task.node_id
        self.recorded += 1
        self.events.append((now, kind, task.job_id, task.index,
                            -1 if nid is None else nid, task.attempts))
        prior = self._chain["on_requeue"]
        if prior is not None:
            prior(task, now)

    def _on_quarantine(self, task, now: float) -> None:
        nid = task.node_id
        self.recorded += 1
        self.events.append((now, "quarantine", task.job_id, task.index,
                            -1 if nid is None else nid, task.attempts))
        prior = self._chain["on_quarantine"]
        if prior is not None:
            prior(task, now)

    def _on_job_done(self, job) -> None:
        self.recorded += 1
        self.events.append((self._sch.loop.now, "job_done", job.job_id,
                            -1, -1, job.state.name))
        prior = self._chain["on_job_done"]
        if prior is not None:
            prior(job)

    def _on_sweep(self, now: float, newly_down: List[int]) -> None:
        self.recorded += 1
        self.events.append((now, "sweep", -1, -1, -1, len(newly_down)))
        prior = self._chain["on_sweep"]
        if prior is not None:
            prior(now, newly_down)

    # RM membership callbacks (plain callback lists, no chaining needed)
    def _on_node_down(self, nid: int) -> None:
        self.recorded += 1
        self.events.append((self._sch.loop.now, "node_down", -1, -1, nid, 0))

    def _on_node_up(self, nid: int) -> None:
        self.recorded += 1
        self.events.append((self._sch.loop.now, "node_up", -1, -1, nid, 0))

    def _on_node_mute(self, nid: int, muted: bool) -> None:
        self.recorded += 1
        self.events.append((self._sch.loop.now,
                            "mute" if muted else "unmute", -1, -1, nid, 0))

    # ----------------------------------------------------------- reading
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            k = ev[1]
            out[k] = out.get(k, 0) + 1
        return out

    def events_normalized(self, idmap: Dict[int, int]) -> List[Event]:
        """Events with job ids remapped through ``idmap`` (differential
        tests compare runs whose global job-id counters differ)."""
        out: List[Event] = []
        for ev in self.events:
            if ev[1] in _JOB_KINDS:
                ev = (ev[0], ev[1], idmap[ev[2]], ev[3], ev[4], ev[5])
            out.append(ev)
        return out

    # ------------------------------------------------------------ export
    def export_chrome(self, path: str) -> int:
        """Write the buffer as Chrome-trace JSON; returns event count.

        Layout: pid 0 = per-node rows (task spans + dispatch instants),
        pid 1 = scheduler counters (queue depth at each cycle), pid 2 =
        control-plane instants (job lifecycle, membership, faults, sweeps).
        Timestamps are virtual seconds scaled to trace microseconds.
        """
        tev: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 0,
             "args": {"name": "nodes"}},
            {"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "scheduler"}},
            {"ph": "M", "name": "process_name", "pid": 2,
             "args": {"name": "control"}},
        ]
        app = tev.append
        for t, kind, job, task, node, aux in self.events:
            us = t * 1e6
            if kind == "complete" or kind == "failed":
                t0 = aux * 1e6          # dispatch_time carried in aux
                app({"ph": "X", "name": f"j{job}/t{task}", "cat": kind,
                     "ts": t0, "dur": us - t0, "pid": 0, "tid": node,
                     "args": {"ok": kind == "complete"}})
            elif kind == "dispatch":
                app({"ph": "i", "name": "dispatch", "s": "t", "ts": us,
                     "pid": 0, "tid": node,
                     "args": {"job": job, "task": task, "depth": aux}})
            elif kind == "cycle":
                app({"ph": "C", "name": "queue_depth", "ts": us, "pid": 1,
                     "args": {"depth": aux}})
            else:
                args = {"job": job, "task": task, "node": node, "aux": aux}
                app({"ph": "i", "name": kind, "s": "g", "ts": us,
                     "pid": 2, "tid": 0, "args": args})
        with open(path, "w") as fh:
            json.dump({"traceEvents": tev, "displayTimeUnit": "ms"}, fh)
        return len(tev) - 3             # metadata records excluded

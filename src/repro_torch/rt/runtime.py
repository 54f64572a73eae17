"""Wall-clock driver: pumps the virtual-time engine with real deadlines.

:class:`AsyncRuntime` is the third way the engine runs (scheduler.py's
module docstring): the *same* ``Scheduler`` / ``ResourceManager`` /
``EventLoop`` objects, but the loop's clock tracks wall time — every
transport message and timer becomes an event at ``time.monotonic() - t0``,
and ``loop.run(until=wall_now)`` serializes all engine state changes on
the pump thread.  Nothing in core knows it is running in real time.

Mapping onto the fault plane's task lifecycle:

  worker register          ``ResourceManager.add_nodes`` (a Node per worker)
  worker heartbeat         ``rm.heartbeat`` — with ``external_heartbeats``
                           set, sweeps stop auto-stamping, so the
                           scheduler's own ``_heartbeat_sweep`` detects a
                           quiet worker within timeout + interval and its
                           ``_node_down`` requeue/backoff/quarantine path
                           runs unchanged
  lease TTL expiry         ``Scheduler.reclaim_task`` (the node is still
                           UP; only this attempt's lease died — lost
                           grants, restart amnesia, result messages eaten
                           by the transport)
  duplicate/late results   dropped: the lease registry fences by lease id
                           (one id per (task, attempt)), and the engine's
                           ``done`` callback re-fences on ``task.attempts``
  >50% workers gone        graceful degradation: new submissions are shed
                           to a parking list and resubmitted when capacity
                           rejoins (``shed_on_degraded=False`` to disable)

Observability: attach a ``FlightRecorder`` to ``runtime.sch`` as
usual; :meth:`AsyncRuntime.bind_registry` adds rt-plane gauges to a
``Registry``.  :meth:`summary` is the runtime's own ledger (leases,
stale/duplicate results, shedding).

A copy of the reference's ``repro/rt/runtime.py`` over ``repro_torch.core``,
with one repair: a worker's first registration wakes the scheduler
(``Scheduler._node_up``), as a rejoin does. The reference's runtime leaves a
job submitted before the first register waiting forever: on a socket the
register can reach the pump after the submit.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Optional, Set, Tuple

from repro_torch.core.families import LatencyProfile
from repro_torch.core.job import Job, Task
from repro_torch.core.resources import NodeState, ResourceManager
from repro_torch.core.scheduler import Executor, Scheduler, SchedulerConfig
from repro_torch.core.simulator import EventLoop
from repro_torch.rt.comm import Comm, CommClosed, Message, Transport
from repro_torch.rt.worker import SleepPayload

__all__ = ["WALL", "Lease", "AsyncRuntime"]

#: wall-clock runs measure real latency; the model must not add any
WALL = LatencyProfile(name="wall", cycle_interval=0.0)


@dataclass
class Lease:
    """One granted attempt: the fencing token between engine and workers.

    ``lease_id`` embeds (job, index, attempt), so a result that raced a
    reclaim can never complete the successor attempt; ``seen`` flips when
    the worker first acknowledges the lease (heartbeat), which is what the
    claim-token accounting treats as "no longer in flight".
    """

    lease_id: str
    task: Task
    attempt: int
    worker: str
    done: Callable[[bool], None]
    deadline: float
    state: str = "pending"           # pending (unsent) | sent
    seen: bool = False


class _LeaseExecutor(Executor):
    """The engine's Executor seam, pointed at the lease machinery: a
    dispatch becomes a lease grant instead of a local thread."""

    def __init__(self, rt: "AsyncRuntime"):
        self._rt = rt

    def run(self, task: Task, done: Callable[[bool], None]) -> None:
        self._rt._grant_lease(task, done)


class AsyncRuntime:
    """Drive the virtual-time engine against real workers over a transport.

    Thread model: transport receiver threads only enqueue into
    ``_mailbox``; the thread calling :meth:`step` / :meth:`run_until_idle`
    (the *pump*) converts mailbox entries into loop events at the current
    wall instant and runs the loop — so every engine mutation happens on
    one thread, in event order, exactly as in virtual time.
    """

    def __init__(self, transport: Transport, *, address="driver",
                 policy=None, config: Optional[SchedulerConfig] = None,
                 lease_ttl: float = 0.6, heartbeat_interval: float = 0.05,
                 heartbeat_timeout: float = 0.25, duration_scale: float = 1.0,
                 shed_on_degraded: bool = True):
        self.transport = transport
        self.lease_ttl = lease_ttl
        self.duration_scale = duration_scale
        self.shed_on_degraded = shed_on_degraded
        self.loop = EventLoop()
        self.rm = ResourceManager(heartbeat_timeout=heartbeat_timeout)
        self.rm.external_heartbeats = True
        cfg = config or SchedulerConfig()
        if cfg.heartbeat_interval <= 0.0:
            cfg.heartbeat_interval = heartbeat_interval
        self.sch = Scheduler(self.rm, policy=policy, profile=WALL,
                             loop=self.loop, executor=_LeaseExecutor(self),
                             config=cfg)
        # runtime hooks go in before any FlightRecorder/tap chains on top
        self.sch.on_job_done = self._on_job_done
        self.rm.on_node_down(self._on_node_down)
        self.rm.on_node_up(self._on_node_up)
        # ---------------------------------------------------------- state
        self._t0 = time.monotonic()
        self._mailbox: "queue.Queue" = queue.Queue()
        self._wake = threading.Event()
        self._comms: Dict[str, Comm] = {}          # worker id -> live comm
        self._worker_node: Dict[str, int] = {}
        self._node_worker: Dict[int, str] = {}
        self._claims: Dict[str, int] = {}          # standing claim tokens
        self._offers: Dict[str, Deque[str]] = {}   # unsent lease ids
        self._leases: Dict[str, Lease] = {}
        self._wleases: Dict[str, Set[str]] = {}    # worker -> lease ids
        self._peak_workers = 0
        self._expected = 0                         # jobs handed to submit()
        self._retired = 0
        self.shed: list = []
        self.errors: Dict[Tuple[int, int], str] = {}
        # ledger
        self.leases_granted = 0
        self.leases_expired = 0
        self.leases_orphaned = 0                   # purged with a dead node
        self.accepted_results = 0
        self.stale_results = 0                     # fenced duplicates/lates
        self.shed_jobs = 0
        self.resubmitted = 0
        self.send_failures = 0
        self.listener = transport.listen(address, self._on_connect)
        self.address = self.listener.address

    # ------------------------------------------------------- thread edges
    def _wall(self) -> float:
        return time.monotonic() - self._t0

    def _on_connect(self, comm: Comm) -> None:
        comm.set_receiver(self._enqueue)

    def _enqueue(self, comm: Comm, msg: Message) -> None:
        self._mailbox.put(("msg", (comm, msg)))
        self._wake.set()

    def submit(self, job: Job) -> None:
        """Thread-safe submission; processed on the pump."""
        self._expected += 1
        self._mailbox.put(("submit", (0.0, job)))
        self._wake.set()

    def submit_at(self, at: float, job: Job) -> None:
        """Submission scheduled at wall time ``at`` (seconds since start) —
        lets tests stage arrivals around fault windows deterministically."""
        self._expected += 1
        self._mailbox.put(("submit", (at, job)))
        self._wake.set()

    # --------------------------------------------------------------- pump
    def step(self) -> None:
        """One non-blocking pump round: mailbox -> events -> run to wall."""
        wall = self._wall()
        loop = self.loop
        while True:
            try:
                kind, payload = self._mailbox.get_nowait()
            except queue.Empty:
                break
            if kind == "msg":
                comm, msg = payload
                loop.at(wall, self._handle, comm, msg)
            else:                                  # "submit"
                at, job = payload
                loop.at(at if at > wall else wall, self._do_submit, job)
        loop.run(until=self._wall())

    def run_until_idle(self, timeout: float) -> bool:
        """Pump until every job handed to ``submit``/``submit_at`` retired
        (shed ones included) or ``timeout`` wall seconds pass.  Returns
        True on idle, False on timeout — the hard bound that keeps a
        wedged transport from wedging the caller."""
        deadline = time.monotonic() + timeout
        while True:
            self.step()
            if self._retired >= self._expected and not self.shed:
                return True
            if time.monotonic() >= deadline:
                return False
            wait = 0.02
            nxt = self.loop.peek()
            if nxt is not None:
                gap = nxt[0] - self._wall()
                if gap < wait:
                    wait = gap if gap > 0.0005 else 0.0005
            self._wake.clear()
            if not self._mailbox.empty():
                continue
            self._wake.wait(wait)

    def close(self, shutdown_workers: bool = False) -> None:
        if shutdown_workers:
            for comm in list(self._comms.values()):
                try:
                    comm.send(("shutdown", {}))
                except CommClosed:
                    pass
        self.listener.close()
        for comm in list(self._comms.values()):
            comm.close()

    # ----------------------------------------------------- message handling
    def _handle(self, comm: Comm, msg: Message) -> None:
        kind, body = msg
        if kind == "heartbeat":
            self._on_heartbeat(comm, body)
        elif kind == "result":
            self._on_result(body)
        elif kind == "claim":
            self._on_claim(comm, body)
        elif kind == "register":
            self._on_register(comm, body)
        elif kind == "bye":
            self._on_bye(body)

    def _on_register(self, comm: Comm, body: dict) -> None:
        w = body["worker"]
        now = self.loop.now
        self._comms[w] = comm
        nid = self._worker_node.get(w)
        joined = nid is None
        if joined:
            nid = self.rm.add_nodes(1, slots=body.get("slots", 1))[0]
            self._worker_node[w] = nid
            self._node_worker[nid] = w
            if len(self._worker_node) > self._peak_workers:
                self._peak_workers = len(self._worker_node)
        self._claims.setdefault(w, 0)
        self.rm.heartbeat(nid, now)    # fresh/rejoining incarnation is live
        if joined:
            # a new node is fresh capacity, as a rejoin is: add_nodes fires
            # no node-up callback, so work submitted before the first
            # worker registered (a socket register can arrive after the
            # submit) would wait for a cycle that nothing requests
            self.sch._node_up(nid)
        self._flush_shed()

    def _admit(self, comm: Comm, body: dict) -> int:
        """Node id for the sender, registering it if the driver never saw
        its ``register`` (dropped message): claims and heartbeats carry
        ``slots``, so any message is enough to (re)admit a worker.  Also
        re-points the worker's comm at the incoming connection (reconnects
        after a chaos reset land here with a fresh comm)."""
        w = body["worker"]
        nid = self._worker_node.get(w)
        if nid is None:
            self._on_register(comm, body)
            nid = self._worker_node[w]
        elif self._comms.get(w) is not comm:
            self._comms[w] = comm
        return nid

    def _on_claim(self, comm: Comm, body: dict) -> None:
        w = body["worker"]
        nid = self._admit(comm, body)
        self.rm.heartbeat(nid, self.loop.now)   # any message proves life
        self._set_tokens(w, body.get("free", 0))
        self._flush_offers(w)

    def _on_heartbeat(self, comm: Comm, body: dict) -> None:
        w = body["worker"]
        nid = self._admit(comm, body)
        now = self.loop.now
        self.rm.heartbeat(nid, now)
        for lid in body.get("leases", ()):
            lease = self._leases.get(lid)
            if lease is not None and lease.worker == w:
                lease.seen = True
                renewed = now + self.lease_ttl
                if renewed > lease.deadline:
                    lease.deadline = renewed   # expiry event re-arms itself
        self._set_tokens(w, body.get("free", 0))
        self._flush_offers(w)

    def _on_result(self, body: dict) -> None:
        lease = self._leases.pop(body["lease"], None)
        if lease is None:
            # reclaimed, already answered, or a chaos duplicate: fenced
            self.stale_results += 1
            return
        self._wleases.get(lease.worker, set()).discard(lease.lease_id)
        ok = bool(body.get("ok", False))
        if not ok and body.get("error"):
            self.errors[lease.task.key] = body["error"]
        self.accepted_results += 1
        # the engine re-fences on task.attempts inside this callback, so a
        # lease that survived a node-death requeue still cannot complete
        # the successor attempt
        lease.done(ok)

    def _on_bye(self, body: dict) -> None:
        w = body["worker"]
        nid = self._worker_node.get(w)
        if nid is not None \
                and self.rm.nodes[nid].state is NodeState.UP:
            # a goodbye is an announced failure: requeue its work now
            # instead of waiting out the heartbeat timeout
            self.rm.mark_down(nid)
        comm = self._comms.pop(w, None)
        if comm is not None:
            comm.close()

    # ------------------------------------------------------ lease machinery
    def _grant_lease(self, task: Task, done: Callable[[bool], None]) -> None:
        nid = task.node_id
        w = self._node_worker.get(nid)
        now = self.loop.now
        lid = f"{task.job_id}.{task.index}.{task.attempts}"
        lease = Lease(lid, task, task.attempts, w, done,
                      deadline=now + self.lease_ttl)
        self._leases[lid] = lease
        self._wleases.setdefault(w, set()).add(lid)
        self.leases_granted += 1
        self.loop.at(lease.deadline, self._lease_deadline, lid)
        self._offers.setdefault(w, collections.deque()).append(lid)
        self._flush_offers(w)

    def _set_tokens(self, w: str, free: int) -> None:
        # leases on the wire (sent, never acknowledged) still occupy the
        # slots the worker just advertised as free
        leases = self._leases
        in_flight = sum(
            1 for lid in self._wleases.get(w, ())
            if (lease := leases.get(lid)) is not None
            and lease.state == "sent" and not lease.seen)
        tokens = free - in_flight
        self._claims[w] = tokens if tokens > 0 else 0

    def _flush_offers(self, w: str) -> None:
        offers = self._offers.get(w)
        if not offers:
            return
        tokens = self._claims.get(w, 0)
        comm = self._comms.get(w)
        while tokens > 0 and offers:
            lid = offers.popleft()
            lease = self._leases.get(lid)
            if lease is None or lease.state != "pending":
                continue               # expired or already sent
            if comm is None or comm.closed:
                offers.appendleft(lid)
                break
            task = lease.task
            try:
                comm.send(("lease", {
                    "lease": lid, "payload": task.payload,
                    "duration": task.duration * self.duration_scale}))
            except CommClosed:
                self.send_failures += 1
                offers.appendleft(lid)  # TTL reclaims if the link stays dead
                break
            lease.state = "sent"
            tokens -= 1
        self._claims[w] = tokens

    def _lease_deadline(self, lid: str) -> None:
        lease = self._leases.get(lid)
        if lease is None:
            return                     # resolved or purged meanwhile
        now = self.loop.now
        if now < lease.deadline:
            self.loop.at(lease.deadline, self._lease_deadline, lid)
            return                     # renewed: chase the new deadline
        del self._leases[lid]
        self._wleases.get(lease.worker, set()).discard(lid)
        self.leases_expired += 1
        # still-RUNNING attempt -> the fault plane's loss path (requeue/backoff/
        # quarantine); fenced no-op if the attempt already moved on
        self.sch.reclaim_task(lease.task, attempt=lease.attempt)

    # ----------------------------------------------------- node transitions
    def _on_node_down(self, nid: int) -> None:
        # Scheduler._node_down (registered first) already requeued the
        # node's RUNNING work; drop the dead incarnation's leases so late
        # results fence as stale and nothing leaks
        w = self._node_worker.get(nid)
        if w is None:
            return
        for lid in self._wleases.get(w, ()):
            if self._leases.pop(lid, None) is not None:
                self.leases_orphaned += 1
        self._wleases[w] = set()
        self._offers.pop(w, None)
        self._claims[w] = 0

    def _on_node_up(self, nid: int) -> None:
        self._flush_shed()

    def _on_job_done(self, job: Job) -> None:
        self._retired += 1

    # ------------------------------------------------- graceful degradation
    @property
    def up_workers(self) -> int:
        nodes = self.rm.nodes
        return sum(1 for nid in self._node_worker
                   if nodes[nid].state is NodeState.UP)

    @property
    def degraded(self) -> bool:
        """True when more than half the fleet (at peak membership) is gone."""
        peak = self._peak_workers
        return peak > 0 and self.up_workers * 2 < peak

    def _do_submit(self, job: Job) -> None:
        if self.shed_on_degraded and self.degraded:
            self.shed.append(job)
            self.shed_jobs += 1
            return
        scale = self.duration_scale
        for t in job.tasks:
            if t.payload is None:
                t.payload = SleepPayload(t.duration * scale)
        self.sch.submit(job)

    def _flush_shed(self) -> None:
        if not self.shed or self.degraded:
            return
        shed, self.shed = self.shed, []
        for job in shed:
            self.resubmitted += 1
            self._do_submit(job)

    # ------------------------------------------------------- observability
    def bind_registry(self, reg) -> None:
        """Expose the rt plane on an obs ``Registry`` as lazy gauges."""
        reg.gauge("rt.workers_up", lambda: self.up_workers)
        reg.gauge("rt.workers_peak", lambda: self._peak_workers)
        reg.gauge("rt.leases_outstanding", lambda: len(self._leases))
        reg.gauge("rt.leases_granted", lambda: self.leases_granted)
        reg.gauge("rt.leases_expired", lambda: self.leases_expired)
        reg.gauge("rt.leases_orphaned", lambda: self.leases_orphaned)
        reg.gauge("rt.results_accepted", lambda: self.accepted_results)
        reg.gauge("rt.results_stale", lambda: self.stale_results)
        reg.gauge("rt.shed_jobs", lambda: self.shed_jobs)
        reg.gauge("rt.degraded", lambda: self.degraded)

    def summary(self) -> Dict[str, object]:
        return {
            "workers_peak": self._peak_workers,
            "workers_up": self.up_workers,
            "leases_granted": self.leases_granted,
            "leases_expired": self.leases_expired,
            "leases_orphaned": self.leases_orphaned,
            "leases_outstanding": len(self._leases),
            "results_accepted": self.accepted_results,
            "results_stale": self.stale_results,
            "send_failures": self.send_failures,
            "shed_jobs": self.shed_jobs,
            "resubmitted": self.resubmitted,
            "jobs_expected": self._expected,
            "jobs_retired": self._retired,
            "sch_completed": self.sch.completed,
            "sch_requeues": self.sch.requeues,
            "sch_quarantined": self.sch.quarantined,
        }

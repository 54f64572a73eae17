"""Fault plane: seeded, deterministic failure injection for the engine.

The paper's feature analysis ranks resilience mechanisms (fault tolerance,
restartability, task migration) among the defining scheduler features; this
module is the injection side of that story.  A :class:`FaultPlane` drives a
schedule of failures — independent node crashes with MTBF/MTTR
distributions, correlated failure-domain (rack) outages, transient flaps,
silent deaths and heartbeat loss, slow/degraded nodes — as events against
the scheduler's virtual clock, drawn from one ``random.Random(seed)``.
Same (workload seed, fault seed): same crashes, same requeues, same final
job states, bit for bit, on both the per-event and the wave-batched hot
path (tests/test_faultplane.py pins this differentially).

Mechanics mirror the streaming injector's one-lookahead contract: the plane
keeps its full schedule in an internal heap and exposes exactly one pending
event to the EventLoop at a time.  Every fired event applies its effect
through the ResourceManager (``mark_down`` / ``heartbeat`` /
``fail_silent`` / ``set_muted`` / ``set_slow``), draws the successor event
for that entity, and re-arms.  Two liveness rules keep runs finite and
deadlock-free:

* recovery events (repairs, unmutes, restores) are always delivered — a
  cluster is never left broken because the workload drained;
* failure events are *held* while the scheduler has no active jobs: the
  plane delivers only pending recoveries (scanning past held failures, so
  the cluster heals and the loop drains instead of churning a workless
  cluster forever) and re-arms the held schedule from the scheduler's
  ``on_submit`` hook or the loop's source refill.

Silent-death composition: an undetected dead node whose repair arrives
before any heartbeat sweep noticed the lapse is force-detected first
(``mark_down`` then ``heartbeat``) — a rebooted node reports as a fresh
incarnation, so its leases are requeued exactly once and no task is ever
left RUNNING on a node that "recovered" around it.

A copy of the reference's ``repro/core/faults.py``; test files named
below are the reference's, and ``tests/test_torch_faults.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

import heapq
import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.core.resources import NodeState
from repro_torch.core.scheduler import Scheduler

__all__ = ["FaultProfile", "FaultPlane", "WallFaultArm"]


@dataclass(frozen=True)
class FaultProfile:
    """A named fault regime, in virtual seconds.  All rates are *per
    entity* (node or domain) mean times between events; 0 disables that
    fault class.  Exponential interarrivals throughout (the memoryless
    baseline every reliability model starts from)."""

    name: str = "faults"
    # independent node crashes (announced unless ``silent_fraction`` says
    # otherwise): down for Exp(mttr), then rejoin
    mtbf: float = 0.0
    mttr: float = 60.0
    #: fraction of crashes that are *silent* — the node keeps its UP state
    #: and its leases until a heartbeat sweep detects the lapse.  Requires
    #: the scheduler to run sweeps (``heartbeat_interval > 0``).
    silent_fraction: float = 0.0
    # transient flaps: announced, but repaired quickly
    flap_mtbf: float = 0.0
    flap_mttr: float = 2.0
    # correlated failure domains: consecutive node-id blocks of
    # ``domain_size`` share a rack/switch that fails as a unit
    domain_size: int = 0
    domain_mtbf: float = 0.0
    domain_mttr: float = 120.0
    # heartbeat loss without death: the node mutes for Exp(mute_mttr) while
    # its tasks keep completing — sweeps may requeue live work (false
    # positive).  Requires sweeps, like silent deaths.
    mute_mtbf: float = 0.0
    mute_mttr: float = 30.0
    # slow/degraded nodes: payload durations stretch by ``degrade_factor``
    # for tasks dispatched during the degradation window
    degrade_mtbf: float = 0.0
    degrade_mttr: float = 120.0
    degrade_factor: float = 4.0
    #: no *new* failures are generated after this virtual time (repairs
    #: still fire); inf = churn for the lifetime of the workload
    horizon: float = float("inf")


# internal event kinds (heap entries are (time, seq, kind, entity-id))
_CRASH, _REPAIR, _FLAP, _FLAP_END, _DOM_FAIL, _DOM_REPAIR, \
    _MUTE, _UNMUTE, _DEGRADE, _RESTORE = range(10)

_RECOVERY = frozenset((_REPAIR, _FLAP_END, _DOM_REPAIR, _UNMUTE, _RESTORE))

#: stable wire names for the event kinds (flight-recorder / registry feed)
KIND_NAMES = ("crash", "repair", "flap", "flap_end", "domain_fail",
              "domain_repair", "mute", "unmute", "degrade", "restore")


class FaultPlane:
    """Inject a :class:`FaultProfile` into a scheduler's event loop.

    Attach before (or during) a run::

        plane = FaultPlane(sch, FaultProfile(mtbf=2000, mttr=60), seed=1)
        ...
        sch.run()
        plane.summary()

    Determinism: one ``random.Random(seed)`` drawn only inside event
    application, whose order the event loop fixes — so a (workload, fault)
    seed pair replays the identical schedule across runs and across the
    per-event / wave-batched dispatch paths.
    """

    def __init__(self, sch: Scheduler, profile: FaultProfile, *,
                 seed: int = 0, start: float = 0.0):
        if profile.silent_fraction > 0.0 or profile.mute_mtbf > 0.0:
            if sch.config.heartbeat_interval <= 0.0:
                raise ValueError(
                    "silent/mute faults need heartbeat sweeps: set "
                    "SchedulerConfig.heartbeat_interval > 0 (otherwise a "
                    "silently-dead node's leases would never be requeued)")
        self.sch = sch
        self.rm = sch.rm
        self.profile = profile
        self.rng = random.Random(seed)
        self._heap: List[Tuple[float, int, int, int]] = []
        self._seq = 0              # internal heap tie-break (deterministic)
        self._armed = False        # exactly one event pending on the loop
        # outage holds per node: >0 means some fault source keeps it down
        # (an overlapping domain outage + node crash repairs only when the
        # *last* hold lifts)
        self._holds: Dict[int, int] = {}
        self._silent_down: Dict[int, float] = {}   # nid -> t_fail, undetected
        self._mute_started: Dict[int, float] = {}  # nid -> t_mute
        # ---------------------------------------------------- observability
        self.injected: Dict[str, int] = {
            "crash": 0, "silent": 0, "flap": 0, "domain_outage": 0,
            "mute": 0, "degrade": 0}
        self.recoveries = 0
        self.detection_latency: List[float] = []   # silent death -> DOWN
        self.false_positives = 0                   # mute windows detected
        self.downtime_node_s = 0.0
        self._down_since: Dict[int, float] = {}
        # ------------------------------------------------------- schedule
        p = profile
        nids = sorted(self.rm.nodes)
        if p.mtbf > 0.0:
            for nid in nids:
                self._push(start + self._exp(p.mtbf), _CRASH, nid)
        if p.flap_mtbf > 0.0:
            for nid in nids:
                self._push(start + self._exp(p.flap_mtbf), _FLAP, nid)
        if p.mute_mtbf > 0.0:
            for nid in nids:
                self._push(start + self._exp(p.mute_mtbf), _MUTE, nid)
        if p.degrade_mtbf > 0.0:
            for nid in nids:
                self._push(start + self._exp(p.degrade_mtbf), _DEGRADE, nid)
        if p.domain_size > 0 and p.domain_mtbf > 0.0:
            n_domains = (len(nids) + p.domain_size - 1) // p.domain_size
            for d in range(n_domains):
                self._push(start + self._exp(p.domain_mtbf), _DOM_FAIL, d)
        # ------------------------------------------------------- wiring
        #: observability hook: ``on_event(now, kind_name, entity_id)`` fires
        #: for every delivered fault event, after its effect is applied.
        #: None-checked like the scheduler hooks — unobserved planes pay one
        #: comparison per event.
        self.on_event = None
        self.rm.on_node_down(self._on_down)
        self.rm.on_node_up(self._on_up)
        sch.loop.add_source(self._refill)
        self._chain_submit = sch.on_submit
        sch.on_submit = self._on_submit
        self._maybe_arm()

    # ------------------------------------------------------------ plumbing
    def _exp(self, mean: float) -> float:
        return self.rng.expovariate(1.0 / mean)

    def _push(self, t: float, kind: int, ent: int) -> None:
        if kind not in _RECOVERY and t > self.profile.horizon:
            return              # past the churn horizon: never generated
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, ent))

    def _maybe_arm(self) -> None:
        """Expose the next deliverable event to the loop.

        While the scheduler has active jobs that is simply the heap head.
        While it does not, failures are *held* and only pending recoveries
        are delivered (found by scanning past held failures), so the
        cluster always heals but an idle engine never advances the clock
        through workless churn.  Held failures keep their schedule times;
        those times clamp to "now" on delivery, i.e. a crash that came due
        during idle fires as soon as there is work to disturb.
        """
        if self._armed or not self._heap:
            return
        if self.sch._active_jobs:
            t = self._heap[0][0]
        else:
            t = min((e[0] for e in self._heap if e[2] in _RECOVERY),
                    default=None)
            if t is None:
                return          # nothing pending but held failures
        self._armed = True
        now = self.sch.loop.now
        self.sch.loop.at(t if t > now else now, self._fire)

    def _refill(self) -> bool:
        """EventLoop drain hook: resume a held schedule when work exists."""
        self._maybe_arm()
        return self._armed

    def _on_submit(self, job) -> None:
        self._maybe_arm()
        if self._chain_submit is not None:
            self._chain_submit(job)

    def _fire(self) -> None:
        self._armed = False
        if self.sch._active_jobs:
            t, _, kind, ent = heapq.heappop(self._heap)
        else:
            # the workload drained since arming: deliver the earliest
            # pending recovery only, leaving held failures in the heap
            entry, held = None, []
            while self._heap:
                e = heapq.heappop(self._heap)
                if e[2] in _RECOVERY:
                    entry = e
                    break
                held.append(e)
            for e in held:
                heapq.heappush(self._heap, e)
            if entry is None:
                self._maybe_arm()
                return
            t, _, kind, ent = entry
        now = self.sch.loop.now
        if kind == _CRASH:
            self._crash(ent, now)
            self._push(now + self._exp(self.profile.mttr), _REPAIR, ent)
        elif kind == _REPAIR:
            self._release_hold(ent, now)
            self._push(now + self._exp(self.profile.mtbf), _CRASH, ent)
        elif kind == _FLAP:
            self.injected["flap"] += 1
            self._take_hold(ent, now, silent=False)
            self._push(now + self._exp(self.profile.flap_mttr),
                       _FLAP_END, ent)
        elif kind == _FLAP_END:
            self._release_hold(ent, now)
            self._push(now + self._exp(self.profile.flap_mtbf), _FLAP, ent)
        elif kind == _DOM_FAIL:
            self.injected["domain_outage"] += 1
            lo = ent * self.profile.domain_size
            hi = lo + self.profile.domain_size
            for nid in range(lo, min(hi, len(self.rm.nodes))):
                self._take_hold(nid, now, silent=False)
            self._push(now + self._exp(self.profile.domain_mttr),
                       _DOM_REPAIR, ent)
        elif kind == _DOM_REPAIR:
            lo = ent * self.profile.domain_size
            hi = lo + self.profile.domain_size
            for nid in range(lo, min(hi, len(self.rm.nodes))):
                self._release_hold(nid, now)
            self._push(now + self._exp(self.profile.domain_mtbf),
                       _DOM_FAIL, ent)
        elif kind == _MUTE:
            self.injected["mute"] += 1
            self._mute_started[ent] = now
            self.rm.set_muted(ent, True, now)
            self._push(now + self._exp(self.profile.mute_mttr), _UNMUTE, ent)
        elif kind == _UNMUTE:
            self.recoveries += 1
            self._mute_started.pop(ent, None)
            self.rm.set_muted(ent, False, now)   # rejoins if falsely detected
            self._push(now + self._exp(self.profile.mute_mtbf), _MUTE, ent)
        elif kind == _DEGRADE:
            self.injected["degrade"] += 1
            self.rm.set_slow(ent, self.profile.degrade_factor)
            self._push(now + self._exp(self.profile.degrade_mttr),
                       _RESTORE, ent)
        elif kind == _RESTORE:
            self.recoveries += 1
            self.rm.set_slow(ent, 1.0)
            self._push(now + self._exp(self.profile.degrade_mtbf),
                       _DEGRADE, ent)
        if self.on_event is not None:
            self.on_event(now, KIND_NAMES[kind], ent)
        self._maybe_arm()

    # ------------------------------------------------------------- effects
    def _crash(self, nid: int, now: float) -> None:
        silent = (self.profile.silent_fraction > 0.0
                  and self.rng.random() < self.profile.silent_fraction)
        if silent:
            self.injected["silent"] += 1
        else:
            self.injected["crash"] += 1
        self._take_hold(nid, now, silent=silent)

    def _take_hold(self, nid: int, now: float, *, silent: bool) -> None:
        held = self._holds.get(nid, 0)
        self._holds[nid] = held + 1
        node = self.rm.nodes[nid]
        if node.state is not NodeState.UP:
            return              # already down (overlapping outage)
        if silent:
            self._silent_down[nid] = now
            self.rm.fail_silent(nid, now)
        else:
            # an announced failure force-detects any pending silent death
            self.rm.mark_down(nid)

    def _release_hold(self, nid: int, now: float) -> None:
        held = self._holds.get(nid, 0)
        if held <= 0:
            return
        self._holds[nid] = held - 1
        if held > 1:
            return              # another outage source still holds it down
        self.recoveries += 1
        node = self.rm.nodes[nid]
        if node.state is NodeState.UP and not node.alive:
            # silent death repaired before any sweep noticed: the reboot is
            # the detection — requeue its leases first, then rejoin as a
            # fresh incarnation
            self.rm.mark_down(nid)
        self.rm.heartbeat(nid, now)

    def _on_down(self, nid: int) -> None:
        """RM down-callback (fires for sweeps and announced failures alike):
        close the books on detection latency and downtime."""
        now = self.sch.loop.now
        self._down_since.setdefault(nid, now)
        t_fail = self._silent_down.pop(nid, None)
        if t_fail is not None:
            self.detection_latency.append(now - t_fail)
        if nid in self._mute_started:
            # a live muted node was marked down: false-positive detection
            self.false_positives += 1

    def _on_up(self, nid: int) -> None:
        since = self._down_since.pop(nid, None)
        if since is not None:
            self.downtime_node_s += self.sch.loop.now - since

    # ----------------------------------------------------------- metrics
    def summary(self) -> Dict[str, object]:
        # downtime for nodes currently down counts up to "now"
        now = self.sch.loop.now
        down = self.downtime_node_s
        for nid, since in self._down_since.items():
            node = self.rm.nodes[nid]
            if node.state is NodeState.UP:
                continue
            down += now - since
        lat = self.detection_latency
        return {
            "profile": self.profile.name,
            "injected": dict(self.injected),
            "recoveries": self.recoveries,
            "false_positives": self.false_positives,
            "detection_latency_s": {
                "n": len(lat),
                "mean": sum(lat) / len(lat) if lat else 0.0,
                "max": max(lat) if lat else 0.0,
            },
            "downtime_node_s": down,
        }

    def close(self) -> None:
        """Detach from the loop (the schedule heap is abandoned)."""
        self.sch.loop.remove_source(self._refill)
        self._heap.clear()


class WallFaultArm:
    """Wall-clock arm of the fault plane: real faults against real workers.

    Where :class:`FaultPlane` flips Node flags in virtual time, this arm
    kills/hangs/restarts actual worker threads and partitions an actual
    transport, scheduled as events on an ``rt.AsyncRuntime``'s wall-paced
    loop.  Deliberately duck-typed (no rt import): it needs only

      * ``runtime.loop`` — an EventLoop whose clock tracks wall time;
      * ``pool`` — ``kill(i) / hang(i) / thaw(i) / restart(i)``
        (``rt.worker.WorkerPool``);
      * ``transport`` — ``partition(bool)`` (``rt.comm.ChaosTransport``),
        only required when partition windows are scheduled.

    Actions fire on the pump thread, serialized with every engine event.
    ``on_event(now, kind, entity)`` matches the virtual plane's hook, so
    ``FlightRecorder.attach_faults`` records wall injections identically;
    ``fired`` is the delivered-schedule ledger tests assert against.

    Build a schedule explicitly (:meth:`at` — deterministic tests) or draw
    one from a seed (:meth:`schedule_random` — chaos soaks).
    """

    KINDS = ("kill", "hang", "thaw", "restart", "partition", "heal")

    def __init__(self, runtime, pool, *, transport=None, seed: int = 0):
        self.runtime = runtime
        self.pool = pool
        self.transport = transport
        self.rng = random.Random(seed)
        self.fired: List[Tuple[float, str, int]] = []
        self.on_event = None           # FlightRecorder.attach_faults hook

    # ----------------------------------------------------------- schedule
    def at(self, t: float, kind: str, ent: int = 0) -> "WallFaultArm":
        """Arm one action at wall time ``t`` (seconds since runtime start)."""
        if kind not in self.KINDS:
            raise ValueError(f"unknown wall fault kind {kind!r}")
        if kind in ("partition", "heal") and self.transport is None:
            raise ValueError("partition faults need a transport")
        self.runtime.loop.at(t, self._fire, kind, ent)
        return self

    def schedule_random(self, horizon: float, *, kills: int = 0,
                        hangs: int = 0, hang_len: float = 0.5,
                        restarts: int = 0, partitions: int = 0,
                        partition_len: float = 0.5) -> "WallFaultArm":
        """Draw a seeded schedule over ``[0, horizon)`` wall seconds.

        Hangs and partitions are windows (the paired thaw/heal is armed
        with the fault, so a soak always ends with the cluster healable).
        """
        rng = self.rng
        n = self.pool.n
        for _ in range(kills):
            self.at(rng.uniform(0.0, horizon), "kill", rng.randrange(n))
        for _ in range(hangs):
            t = rng.uniform(0.0, horizon)
            i = rng.randrange(n)
            self.at(t, "hang", i)
            self.at(t + hang_len, "thaw", i)
        for _ in range(restarts):
            self.at(rng.uniform(0.0, horizon), "restart", rng.randrange(n))
        for _ in range(partitions):
            t = rng.uniform(0.0, horizon)
            self.at(t, "partition")
            self.at(t + partition_len, "heal")
        return self

    # ------------------------------------------------------------- deliver
    def _fire(self, kind: str, ent: int) -> None:
        pool = self.pool
        if kind == "kill":
            pool.kill(ent)
        elif kind == "hang":
            pool.hang(ent)
        elif kind == "thaw":
            pool.thaw(ent)
        elif kind == "restart":
            pool.restart(ent)
        elif kind == "partition":
            self.transport.partition(True)
        elif kind == "heal":
            self.transport.partition(False)
        now = self.runtime.loop.now
        self.fired.append((now, kind, ent))
        if self.on_event is not None:
            self.on_event(now, kind, ent)

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _, kind, _ent in self.fired:
            out[kind] = out.get(kind, 0) + 1
        return out

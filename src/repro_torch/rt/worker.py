"""Worker runtime: the claim → lease(ttl) → heartbeat → result machine.

A :class:`Worker` connects to the driver over any ``rt.comm`` transport and
walks each task through the lifecycle the driver's scheduler mirrors in
virtual time (QUEUED → CLAIMED → RUNNING → DONE/TIMEOUT):

  register    announce ``slots`` execution slots (the driver adds a Node)
  claim       advertise free slots; the driver only sends leases against
              standing claims, so a dead worker is never force-fed work
  lease       the driver's grant: run this payload under ``lease_id``;
              the driver holds a wall-clock TTL against it
  heartbeat   periodic liveness + lease renewal (active lease ids ride
              along); a hung worker stops beating and the driver's
              heartbeat sweep / TTL expiry requeues its work
  result      terminal report per lease; late/duplicate results after the
              driver reclaimed the lease are fenced off driver-side

Payloads run on ``slots`` executor threads.  Everything sent is loss- and
duplication-tolerant by design: claims and heartbeats are re-advertised,
results are idempotent under the driver's lease registry.

Fault hooks (used by ``core.faults.WallFaultArm`` and tests): ``kill()``
drops the worker mid-flight without a goodbye, ``hang()`` freezes result
reporting *and* heartbeats (the silent-death regime), ``thaw()`` resumes.

Socket transports pickle whole messages, so payloads must be picklable:
use :class:`SleepPayload` / :class:`FnPayload` (name-keyed registry)
instead of closures.

A copy of the reference's ``repro/rt/worker.py``, with its own ``PAYLOADS``
table. The slot threads share one process, and PyTorch's current stream is
per thread: a payload that launches on the card runs on its own thread's
stream and waits on an event it recorded there
(``repro_torch.rt.streams.on_thread_stream``), so one task's wait does not
swallow the other slots' work.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from repro_torch.rt.comm import Comm, CommClosed, Message, Transport

__all__ = ["SleepPayload", "FnPayload", "register_payload",
           "Worker", "WorkerPool"]

_STOP = object()


# ------------------------------------------------------- picklable payloads
#: name -> callable registry backing FnPayload across process/socket hops
PAYLOADS: Dict[str, Callable] = {}


def register_payload(name: str, fn: Callable) -> None:
    PAYLOADS[name] = fn


class SleepPayload:
    """Pure wall-clock sleep — the paper's sleep-job benchmark unit."""

    __slots__ = ("seconds",)

    def __init__(self, seconds: float):
        self.seconds = seconds

    def __call__(self):
        if self.seconds > 0:
            time.sleep(self.seconds)

    def __reduce__(self):
        return (SleepPayload, (self.seconds,))


class FnPayload:
    """A registry-keyed callable: pickles as its name + arguments, so both
    sides of a socket resolve it against their own ``PAYLOADS`` table."""

    __slots__ = ("name", "args")

    def __init__(self, name: str, *args):
        self.name = name
        self.args = args

    def __call__(self):
        return PAYLOADS[self.name](*self.args)

    def __reduce__(self):
        return (FnPayload, (self.name,) + tuple(self.args))


# ------------------------------------------------------------------ worker
class Worker:
    """One worker process-equivalent: ``slots`` executor threads + a
    heartbeat thread behind a single comm to the driver."""

    def __init__(self, transport: Transport, address, worker_id: str, *,
                 slots: int = 1, hb_every: float = 0.05):
        self.transport = transport
        self.address = address
        self.worker_id = worker_id
        self.slots = slots
        self.hb_every = hb_every
        self._comm: Optional[Comm] = None
        self._q: "queue.Queue" = queue.Queue()
        self._active: Dict[str, dict] = {}       # lease_id -> lease body
        self._lock = threading.Lock()
        self._alive = False
        self._gate = threading.Event()           # cleared = hung
        self._gate.set()
        self._stop_evt = threading.Event()
        self._threads: List[threading.Thread] = []
        self.completed = 0
        self.failed = 0

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._alive = True
        self._stop_evt.clear()
        try:
            self._connect()
        except (CommClosed, OSError, ConnectionError):
            pass              # next heartbeat tick retries the connect
        for i in range(self.slots):
            th = threading.Thread(target=self._exec_loop, daemon=True,
                                  name=f"{self.worker_id}-exec{i}")
            th.start()
            self._threads.append(th)
        th = threading.Thread(target=self._hb_loop, daemon=True,
                              name=f"{self.worker_id}-hb")
        th.start()
        self._threads.append(th)

    def _connect(self) -> None:
        comm = self.transport.connect(self.address)
        comm.set_receiver(self._on_msg)
        self._comm = comm
        self._raw_send(("register",
                        {"worker": self.worker_id, "slots": self.slots}))
        self._raw_send(("claim", {"worker": self.worker_id,
                                  "slots": self.slots,
                                  "free": self._free()}))

    def stop(self) -> None:
        """Graceful: tell the driver goodbye, then tear down like kill."""
        self._send(("bye", {"worker": self.worker_id}))
        self.kill()

    def kill(self) -> None:
        """Abrupt death: no goodbye, no result for in-flight leases.  The
        driver only finds out via missed heartbeats / TTL expiry."""
        self._alive = False
        self._stop_evt.set()
        self._gate.set()              # unblock anything parked by hang()
        for _ in range(self.slots):
            self._q.put(_STOP)
        comm = self._comm
        if comm is not None:
            comm.close()

    def hang(self) -> None:
        """Freeze: payloads already running finish their sleep but nothing
        is ever reported and heartbeats stop — indistinguishable from a
        silent death until :meth:`thaw`."""
        self._gate.clear()

    def thaw(self) -> None:
        self._gate.set()

    @property
    def alive(self) -> bool:
        return self._alive

    @property
    def hung(self) -> bool:
        return not self._gate.is_set()

    # ------------------------------------------------------------- wiring
    def _on_msg(self, _comm: Comm, msg: Message) -> None:
        kind, body = msg
        if kind == "lease":
            self._q.put(body)
        elif kind == "shutdown":
            self.kill()

    def _free(self) -> int:
        with self._lock:
            busy = len(self._active)
        return max(self.slots - busy - self._q.qsize(), 0)

    def _raw_send(self, msg: Message) -> None:
        comm = self._comm
        if comm is None:
            raise CommClosed(self.worker_id)
        comm.send(msg)

    def _send(self, msg: Message) -> None:
        """Loss-tolerant send: a dead connection triggers one reconnect
        attempt (fresh register + claim); the triggering message is lost,
        which the protocol absorbs — claims/heartbeats repeat, and a lost
        result is exactly a lease the driver's TTL reclaims."""
        if not self._alive:
            return
        try:
            self._raw_send(msg)
        except (CommClosed, OSError, ConnectionError):
            try:
                self._connect()
            except (CommClosed, OSError, ConnectionError):
                pass                  # next heartbeat tick retries

    # -------------------------------------------------------------- loops
    def _exec_loop(self) -> None:
        while self._alive:
            try:
                body = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if body is _STOP:
                break
            self._gate.wait()
            if not self._alive:
                break
            lid = body["lease"]
            with self._lock:
                self._active[lid] = body
            ok, err = True, None
            try:
                payload = body.get("payload")
                if payload is not None:
                    payload()
                elif body.get("duration"):
                    time.sleep(body["duration"])
            except BaseException:     # noqa: BLE001 — reported, not raised
                ok, err = False, traceback.format_exc(limit=3)
            self._gate.wait()         # a hung worker never reports
            with self._lock:
                self._active.pop(lid, None)
            if not self._alive:
                break
            if ok:
                self.completed += 1
            else:
                self.failed += 1
            self._send(("result", {"worker": self.worker_id, "lease": lid,
                                   "ok": ok, "error": err}))
            self._send(("claim", {"worker": self.worker_id,
                                  "slots": self.slots,
                                  "free": self._free()}))

    def _hb_loop(self) -> None:
        while not self._stop_evt.wait(self.hb_every):
            if not self._alive:
                break
            if not self._gate.is_set():
                continue              # hung: no beats
            with self._lock:
                leases = list(self._active)
            # slots ride along so a driver that never saw our register
            # (dropped message) can admit us from any heartbeat
            self._send(("heartbeat", {"worker": self.worker_id,
                                      "slots": self.slots,
                                      "free": self._free(),
                                      "leases": leases}))


# -------------------------------------------------------------------- pool
class WorkerPool:
    """A fleet of workers with index-addressable fault hooks.

    ``restart(i)`` spawns a *fresh incarnation* under the same worker id:
    the driver sees the node rejoin, while the old incarnation's leases
    (which the new one does not know) die by TTL — the restart-amnesia
    case the lease registry exists for.
    """

    def __init__(self, transport: Transport, address, n: int, *,
                 slots: int = 1, hb_every: float = 0.05):
        self.transport = transport
        self.address = address
        self.n = n
        self.slots = slots
        self.hb_every = hb_every
        self.workers: Dict[int, Worker] = {}
        self.restarts = 0

    def start(self) -> "WorkerPool":
        for i in range(self.n):
            self._spawn(i)
        return self

    def _spawn(self, i: int) -> Worker:
        w = Worker(self.transport, self.address, f"w{i}",
                   slots=self.slots, hb_every=self.hb_every)
        w.start()
        self.workers[i] = w
        return w

    def kill(self, i: int) -> None:
        self.workers[i].kill()

    def hang(self, i: int) -> None:
        self.workers[i].hang()

    def thaw(self, i: int) -> None:
        self.workers[i].thaw()

    def restart(self, i: int) -> None:
        w = self.workers.get(i)
        if w is not None and w.alive:
            w.kill()
        self.restarts += 1
        self._spawn(i)

    def stop(self) -> None:
        for w in self.workers.values():
            if w.alive:
                w.stop()

    @property
    def alive_count(self) -> int:
        return sum(1 for w in self.workers.values() if w.alive)

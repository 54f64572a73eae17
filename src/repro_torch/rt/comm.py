"""Pluggable comm layer for the wall-clock runtime.

A :class:`Transport` hands out :class:`Comm` endpoints — bidirectional,
ordered, *unreliable-on-request* message pipes carrying picklable
``(kind, body)`` tuples:

  ``InMemoryTransport``  in-process queue pairs: deterministic-enough for
                         seeded chaos soaks, zero serialization, payloads
                         pass by reference.
  ``SocketTransport``    real TCP with length-prefixed pickle framing —
                         the wall-clock (t_s, alpha_s) numbers of
                         ``repro_torch.bench.rt_replay`` include real
                         kernel round-trips.  Messages must pickle (use the
                         payload specs in ``rt/worker.py``).
  ``ChaosTransport``     wraps either: seeded message drop / duplication /
                         delay and connection resets on the *send* side,
                         plus a whole-transport ``partition()`` switch.
                         The runtime's lease/requeue machinery is expected
                         to absorb all of it (the reference's
                         tests/test_rt.py, run against this package by
                         tests/test_torch_ref_rt.py).

Delivery model: a receiver callback (``set_receiver``) is invoked from a
transport thread — receivers must only enqueue (the runtime's mailbox, the
worker's task queue), never touch engine state.  ``recv`` offers blocking
reads for callback-free endpoints (round-trip tests).

A copy of the reference's ``repro/rt/comm.py``; ``SocketListener.close``
also shuts the listening socket down and joins its accept thread, which
the reference leaves blocked in ``accept()``. A socket peer unpickles
``FnPayload`` by its class path and resolves it in its own process's
``PAYLOADS`` table, so this package and the reference do not talk to each
other over a socket.
"""
from __future__ import annotations

import pickle
import random
import socket
import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

Message = Tuple[str, dict]

__all__ = [
    "Message", "CommClosed", "Comm", "Listener", "Transport",
    "InMemoryTransport", "SocketTransport", "ChaosTransport",
]


class CommClosed(Exception):
    """The endpoint (or its peer) is gone; the message was not delivered."""


class Comm:
    """One endpoint of a bidirectional message pipe.

    Subclasses implement :meth:`send` / :meth:`close`; delivery plumbing
    (receiver callback vs. blocking ``recv``) is shared here.
    """

    def __init__(self, label: str = "comm"):
        self.label = label
        self._lock = threading.RLock()
        self._ready = threading.Condition(self._lock)
        self._inbox: list = []
        self._receiver: Optional[Callable[["Comm", Message], None]] = None
        self._closed = False
        #: optional ``callback(comm)`` fired once when the pipe dies
        #: (local close or peer disappearance)
        self.on_close: Optional[Callable[["Comm"], None]] = None

    # ------------------------------------------------------------ sending
    def send(self, msg: Message) -> None:
        raise NotImplementedError

    # ---------------------------------------------------------- receiving
    def set_receiver(self, fn: Callable[["Comm", Message], None]) -> None:
        """Deliver messages via ``fn(comm, msg)`` (transport thread!).

        Messages that arrived before the receiver was installed are
        flushed through it first, in arrival order.
        """
        with self._lock:
            backlog, self._inbox = self._inbox, []
            self._receiver = fn
            for m in backlog:
                fn(self, m)

    def recv(self, timeout: Optional[float] = None) -> Message:
        """Blocking read for callback-free endpoints.

        Raises :class:`CommClosed` once the pipe is dead and drained,
        :class:`TimeoutError` when ``timeout`` elapses first.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._ready:
            while not self._inbox:
                if self._closed:
                    raise CommClosed(self.label)
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(f"recv on {self.label}")
                self._ready.wait(left if left is not None else 0.2)
            return self._inbox.pop(0)

    def _deliver(self, msg: Message) -> None:
        with self._lock:
            if self._closed:
                return
            fn = self._receiver
            if fn is None:
                self._inbox.append(msg)
                self._ready.notify()
                return
        fn(self, msg)

    # ------------------------------------------------------------ closing
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        raise NotImplementedError

    def _mark_closed(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._ready.notify_all()
            cb = self.on_close
        if cb is not None:
            cb(self)


class Listener:
    """Handle for a listening endpoint; ``address`` is the bound address."""

    def __init__(self, address):
        self.address = address

    def close(self) -> None:  # pragma: no cover - overridden
        pass


class Transport:
    """Abstract transport: ``listen`` for inbound comms, ``connect`` out."""

    def listen(self, address,
               handler: Callable[[Comm], None]) -> Listener:
        raise NotImplementedError

    def connect(self, address) -> Comm:
        raise NotImplementedError


# --------------------------------------------------------------- in-memory
class _MemComm(Comm):
    """One side of an in-process pair; ``send`` delivers to the peer."""

    def __init__(self, label: str):
        super().__init__(label)
        self._peer: Optional["_MemComm"] = None

    def send(self, msg: Message) -> None:
        peer = self._peer
        if self._closed or peer is None or peer._closed:
            raise CommClosed(self.label)
        peer._deliver(msg)

    def close(self) -> None:
        peer = self._peer
        self._mark_closed()
        if peer is not None:
            peer._mark_closed()     # TCP-like: the far side reads EOF


class InMemoryTransport(Transport):
    """In-process transport: addresses are plain names in a local table."""

    def __init__(self):
        self._listeners: Dict[object, Callable[[Comm], None]] = {}
        self._n = 0

    def listen(self, address, handler) -> Listener:
        self._listeners[address] = handler
        transport = self

        class _L(Listener):
            def close(self) -> None:
                transport._listeners.pop(address, None)

        return _L(address)

    def connect(self, address) -> Comm:
        handler = self._listeners.get(address)
        if handler is None:
            raise ConnectionRefusedError(f"no listener at {address!r}")
        self._n += 1
        client = _MemComm(f"mem:{address}#{self._n}:client")
        server = _MemComm(f"mem:{address}#{self._n}:server")
        client._peer, server._peer = server, client
        handler(server)
        return client


# ------------------------------------------------------------------- TCP
_HDR = struct.Struct("!I")


def _parse_addr(address) -> Tuple[str, int]:
    if isinstance(address, (tuple, list)):
        return address[0], int(address[1])
    host, _, port = str(address).rpartition(":")
    return host or "127.0.0.1", int(port)


class _SocketComm(Comm):
    """Length-prefixed pickle framing over a connected TCP socket."""

    def __init__(self, sock: socket.socket, label: str):
        super().__init__(label)
        self._sock = sock
        self._wlock = threading.Lock()
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name=f"{label}-rx")
        self._reader.start()

    def send(self, msg: Message) -> None:
        if self._closed:
            raise CommClosed(self.label)
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            with self._wlock:
                self._sock.sendall(_HDR.pack(len(data)) + data)
        except OSError as exc:
            self._teardown()
            raise CommClosed(self.label) from exc

    def _read_loop(self) -> None:
        try:
            while True:
                head = self._read_exact(_HDR.size)
                if head is None:
                    break
                (n,) = _HDR.unpack(head)
                body = self._read_exact(n)
                if body is None:
                    break
                self._deliver(pickle.loads(body))
        except (OSError, pickle.UnpicklingError, EOFError):
            pass
        self._teardown()

    def _read_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _teardown(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        self._mark_closed()

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._teardown()


class SocketListener(Listener):
    def __init__(self, sock: socket.socket, handler):
        host, port = sock.getsockname()[:2]
        super().__init__(f"{host}:{port}")
        self._sock = sock
        self._handler = handler
        self._open = True
        self._n = 0
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="rt-accept")
        self._thread.start()

    def _accept_loop(self) -> None:
        while self._open:
            try:
                conn, peer = self._sock.accept()
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._n += 1
            self._handler(_SocketComm(
                conn, f"tcp:{peer[0]}:{peer[1]}#{self._n}"))

    def close(self) -> None:
        self._open = False
        # shutdown wakes the accept thread (a bare close leaves it blocked
        # in accept() on Linux, and it would outlive the listener)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)


class SocketTransport(Transport):
    """Real TCP; addresses are ``"host:port"`` (port 0 = ephemeral)."""

    def listen(self, address, handler) -> SocketListener:
        host, port = _parse_addr(address)
        sock = socket.create_server((host, port))
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return SocketListener(sock, handler)

    def connect(self, address) -> Comm:
        host, port = _parse_addr(address)
        sock = socket.create_connection((host, port), timeout=5.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return _SocketComm(sock, f"tcp:{host}:{port}:client")


# ----------------------------------------------------------------- chaos
class ChaosComm(Comm):
    """Send-side fault wrapper around a real comm.

    Per-comm ``random.Random`` seeded from (transport seed, comm index):
    the *decision sequence* replays across runs even though wall-clock
    interleavings shift which message meets which decision.  Delayed
    copies are released on daemon timers with a non-decreasing release
    time, so per-comm FIFO ordering survives the jitter (reordering
    *across* comms is the realistic part).
    """

    def __init__(self, inner: Comm, rng: random.Random,
                 transport: "ChaosTransport"):
        super().__init__(f"chaos:{inner.label}")
        self._inner = inner
        self._rng = rng
        self._t = transport
        self._last_at = 0.0          # monotonic floor for delayed releases
        inner.on_close = lambda _c: self._mark_closed()

    # delivery plumbing is the inner comm's
    def set_receiver(self, fn) -> None:
        self._inner.set_receiver(lambda _c, m: fn(self, m))

    def recv(self, timeout: Optional[float] = None) -> Message:
        return self._inner.recv(timeout)

    @property
    def closed(self) -> bool:
        return self._inner.closed

    def close(self) -> None:
        self._inner.close()
        self._mark_closed()

    def send(self, msg: Message) -> None:
        t = self._t
        if self._inner.closed:
            raise CommClosed(self.label)
        if t.partitioned:
            t.stats["partition_dropped"] += 1
            return                   # silently eaten, both directions
        rng = self._rng
        cfg = t
        t.stats["sent"] += 1
        if cfg.reset > 0.0 and rng.random() < cfg.reset:
            t.stats["resets"] += 1
            self.close()             # connection torn down mid-send
            raise CommClosed(self.label)
        copies = 1
        if cfg.dup > 0.0 and rng.random() < cfg.dup:
            copies = 2
            t.stats["duplicated"] += 1
        for _ in range(copies):
            if cfg.drop > 0.0 and rng.random() < cfg.drop:
                t.stats["dropped"] += 1
                continue
            d = rng.uniform(0.0, cfg.delay) if cfg.delay > 0.0 else 0.0
            self._release(msg, d)

    def _release(self, msg: Message, delay: float) -> None:
        now = time.monotonic()
        at = max(now + delay, self._last_at)
        self._last_at = at
        if at <= now:
            self._fwd(msg)
            return
        self._t.stats["delayed"] += 1
        timer = threading.Timer(at - now, self._fwd, (msg,))
        timer.daemon = True
        timer.start()

    def _fwd(self, msg: Message) -> None:
        try:
            self._inner.send(msg)
        except CommClosed:
            pass                     # late release onto a dead pipe


class ChaosTransport(Transport):
    """Wrap a transport; every comm it hands out injects seeded faults.

    ``drop``/``dup``/``reset`` are per-message probabilities, ``delay`` a
    max uniform extra latency in seconds.  ``partition(True)`` eats every
    message on every wrapped comm (both directions — each side's sender is
    wrapped) until ``partition(False)`` heals it.
    """

    def __init__(self, inner: Transport, *, drop: float = 0.0,
                 dup: float = 0.0, delay: float = 0.0, reset: float = 0.0,
                 seed: int = 0):
        self.inner = inner
        self.drop = drop
        self.dup = dup
        self.delay = delay
        self.reset = reset
        self.seed = seed
        self.partitioned = False
        self._idx = 0
        self.stats: Dict[str, int] = {
            "sent": 0, "dropped": 0, "duplicated": 0, "delayed": 0,
            "resets": 0, "partition_dropped": 0}

    def _wrap(self, comm: Comm) -> ChaosComm:
        self._idx += 1
        rng = random.Random((self.seed << 20) ^ self._idx)
        return ChaosComm(comm, rng, self)

    def listen(self, address, handler) -> Listener:
        return self.inner.listen(address,
                                 lambda comm: handler(self._wrap(comm)))

    def connect(self, address) -> Comm:
        return self._wrap(self.inner.connect(address))

    def partition(self, on: bool = True) -> None:
        self.partitioned = on

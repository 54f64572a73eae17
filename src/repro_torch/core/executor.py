"""Task executors: run a task's payload and report its outcome.

  Executor              the interface a scheduler drives: ``run(task,
                        done)`` runs the task and calls ``done(ok)``
                        (defined in ``core/scheduler.py``).
  ThreadExecutor        runs payloads on a pool of worker threads; their
                        completions are marshalled onto the event loop.
  InlineExecutor        runs payloads synchronously in the caller's thread
                        (the scheduler's event loop).
  TorchDispatchExecutor payloads are PyTorch computations; it waits until
                        the device has finished them, so a task's measured
                        latency is dispatch plus execution (the
                        scheduler latency t_s of real dispatch).

A payload's exception is recorded in ``errors[task.key]`` and the task
completes with ``ok=False``, so the scheduler sees a failed attempt. Any
scheduler that calls ``executor.run(task, done)`` can drive these,
the reference's included: a task needs only ``key`` and ``payload``.

Thread-safety contract of ``ThreadExecutor`` (copied from the reference's
``repro/core/executor.py``): worker threads never touch engine state.  A
completing payload enqueues its ``done`` callback on a thread-safe
completion queue; the callback only runs once the queue is *drained on the
event loop* — either by the loop itself (``bind_loop`` registers a drain
source the Scheduler wires up automatically) or by an explicit ``pump()``
from whatever thread owns the engine.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.job import Task
from repro_torch.core.scheduler import Executor

#: queue sentinel that wakes a blocked worker ``get()`` at shutdown
_STOP = object()


class ThreadExecutor(Executor):
    """Runs task payloads on a pool of worker threads ("slots").

    Payload exceptions are never swallowed: the exception object is
    recorded in ``errors[task.key]`` and the task completes with
    ``ok=False`` (the engine's retry lifecycle sees a failed attempt).

    ``done`` callbacks are marshaled through ``_completions`` and run on
    the thread that drains it (the event loop via :meth:`bind_loop`, or a
    :meth:`pump`/:meth:`drain` caller) — never on a worker thread.  Pass
    ``marshal=False`` to restore the legacy fire-from-worker-thread
    behaviour (only safe when the callback is itself thread-safe).
    """

    #: fallback poll period while blocked waiting for completions (only
    #: reached if a payload outlives it; keeps the drain loop interruptible)
    _POLL_S = 1.0

    def __init__(self, workers: int = 4, marshal: bool = True):
        self._q: "queue.Queue" = queue.Queue()
        self._completions: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._stop = False
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._outstanding = 0          # run() called, done() not yet fired
        self._marshal = marshal
        self._loop = None
        self.results: Dict[Tuple[int, int], object] = {}
        self.errors: Dict[Tuple[int, int], BaseException] = {}
        for _ in range(workers):
            th = threading.Thread(target=self._worker, daemon=True)
            th.start()
            self._threads.append(th)

    # ------------------------------------------------------------ workers
    def _worker(self):
        while True:
            item = self._q.get()       # blocking; _STOP wakes us at shutdown
            if item is _STOP:
                self._q.task_done()
                break
            task, done = item
            ok = True
            try:
                if task.payload is not None:
                    self.results[task.key] = task.payload()
                elif task.duration:
                    time.sleep(task.duration)
            except BaseException as exc:    # noqa: BLE001 — recorded, not lost
                ok = False
                self.errors[task.key] = exc
            if self._marshal:
                self._completions.put((done, ok))
            else:
                done(ok)
                with self._idle:
                    self._outstanding -= 1
                    if self._outstanding == 0:
                        self._idle.notify_all()
            self._q.task_done()

    # ------------------------------------------------------------- submit
    def run(self, task: Task, done: Callable[[bool], None]) -> None:
        with self._lock:
            self._outstanding += 1
        self._q.put((task, done))

    # ---------------------------------------------------------- completion
    def pump(self, block: bool = False, timeout: Optional[float] = None) -> int:
        """Fire ready ``done`` callbacks on the *calling* thread.

        Returns the number fired.  ``block=True`` waits up to ``timeout``
        for the first completion when none is ready.
        """
        n = 0
        while True:
            try:
                done, ok = self._completions.get(
                    block=block and n == 0, timeout=timeout)
            except queue.Empty:
                break
            done(ok)
            with self._idle:
                self._outstanding -= 1
                if self._outstanding == 0:
                    self._idle.notify_all()
            n += 1
        return n

    def bind_loop(self, loop) -> None:
        """Register the completion queue as a drain source on ``loop``.

        The Scheduler calls this automatically for executors that expose
        it: when the loop's heap runs dry with payloads still in flight,
        the source blocks for the next completion and schedules its
        ``done`` at the loop's current instant — completions are *events*,
        serialized with every other engine state change.
        """
        if self._loop is loop:
            return
        self._loop = loop
        loop.add_source(self._drain_source)

    def _drain_source(self) -> bool:
        loop = self._loop
        scheduled = 0
        while True:
            try:
                done, ok = self._completions.get_nowait()
            except queue.Empty:
                break
            loop.at(loop.now, self._fire, done, ok)
            scheduled += 1
        if scheduled:
            return True
        with self._lock:
            outstanding = self._outstanding
        if outstanding <= 0 or self._stop:
            return False               # nothing in flight: let the loop end
        # work in flight but nothing ready: block for the next completion
        # (bounded poll so a wedged payload cannot make the loop unkillable)
        try:
            done, ok = self._completions.get(timeout=self._POLL_S)
        except queue.Empty:
            # re-check outstanding on the next poll round without advancing
            # virtual time
            loop.at(loop.now, _noop)
            return True
        loop.at(loop.now, self._fire, done, ok)
        return True

    def _fire(self, done: Callable[[bool], None], ok: bool) -> None:
        done(ok)
        with self._idle:
            self._outstanding -= 1
            if self._outstanding == 0:
                self._idle.notify_all()

    # ------------------------------------------------------------ teardown
    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted payload ran *and* its completion was
        fired (pumping from this thread while waiting)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._outstanding <= 0:
                    return
            self.pump(block=True, timeout=0.05)
            if deadline is not None and time.monotonic() > deadline:
                with self._lock:
                    left = self._outstanding
                raise TimeoutError(
                    f"drain: {left} payloads still outstanding")

    def shutdown(self, join: bool = True, timeout: float = 5.0) -> None:
        """Stop the pool deterministically.

        A ``_STOP`` sentinel per thread wakes blocked ``get()``s (the old
        poll-flag shutdown left threads parked for up to their poll
        period); ``join=True`` then joins every worker.  Queued-but-unrun
        payloads are discarded; already-marshaled completions remain
        pumpable via :meth:`pump`/:meth:`drain`.
        """
        self._stop = True
        for _ in self._threads:
            self._q.put(_STOP)
        if join:
            for th in self._threads:
                th.join(timeout)
        self._threads = [t for t in self._threads if t.is_alive()]

    @property
    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding


def _noop() -> None:
    """Scheduled by the drain source's poll fallback (no state change)."""


class InlineExecutor(Executor):
    """Runs payloads synchronously in the event loop."""

    def __init__(self):
        self.results: Dict[Tuple[int, int], object] = {}
        self.errors: Dict[Tuple[int, int], BaseException] = {}

    def run(self, task: Task, done: Callable[[bool], None]) -> None:
        ok = True
        try:
            if task.payload is not None:
                self.results[task.key] = self._finish(task.payload())
        except Exception as exc:  # noqa: BLE001 - recorded, not lost
            ok = False
            self.errors[task.key] = exc
        done(ok)

    def _finish(self, out):
        return out


class TorchDispatchExecutor(InlineExecutor):
    """Payloads are PyTorch computations; each task completes when the
    device has finished its work."""

    def _finish(self, out):
        return _block(out)


def _block(out):
    """Wait for every CUDA tensor among the leaves of ``out``: one
    synchronise of the current stream per device; CPU tensors are done
    when the call returns."""
    devices = {x.device for x in tree_lib.leaves(out)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return out

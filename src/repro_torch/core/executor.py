"""Task executors: run a task's payload and report its outcome.

  Executor              the interface a scheduler drives: ``run(task,
                        done)`` runs the task and calls ``done(ok)``.
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
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.job import Task


class Executor:
    """Real-execution backend interface."""

    def run(self, task: Task, done: Callable[[bool], None]) -> None:
        raise NotImplementedError


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

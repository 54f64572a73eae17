"""Fault tolerance for training runs over many slices.

Components:
  * HeartbeatMonitor: per-slice liveness from the resource manager
    (``core/resources.py``); a slice whose beats lapse is marked DOWN.
  * ElasticPlan: given the surviving slices, the shrunken data axis (the
    model axis is never shrunk: tensor-parallel shards are load-bearing)
    and the per-replica batch that keeps the global batch where it
    divides.
  * TrainSupervisor: the train loop as a restartable state machine: step,
    then (maybe) checkpoint; on a failure, restore the newest committed
    checkpoint, plan the re-mesh and resume from the step it recorded. The
    data pipeline is seeded per step, so the resumed run is bit-exact at
    unchanged scale.

On one card there is no mesh to rebuild: the plan is computed and reported
all the same, and handed to the caller's ``remesh_fn``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.resources import NodeState, ResourceManager


@dataclass
class SliceState:
    slice_id: int
    healthy: bool = True
    last_heartbeat: float = 0.0


class HeartbeatMonitor:
    """Tracks slice liveness, one resource-manager node per slice."""

    def __init__(self, n_slices: int, timeout: float = 30.0):
        self.rm = ResourceManager(heartbeat_timeout=timeout)
        self.rm.add_nodes(n_slices, slots=1)
        self.timeout = timeout

    def beat(self, slice_id: int, now: Optional[float] = None) -> None:
        self.rm.heartbeat(slice_id, now if now is not None else time.time())

    def check(self, now: Optional[float] = None) -> List[int]:
        return self.rm.check_heartbeats(now if now is not None
                                        else time.time())

    def healthy_slices(self) -> List[int]:
        return [n.node_id for n in self.rm.up_nodes()]

    def fail(self, slice_id: int) -> None:
        self.rm.mark_down(slice_id)


@dataclass(frozen=True)
class ElasticPlan:
    """A re-mesh decision after slices are lost or gained."""

    data_parallel: int
    model_parallel: int
    global_batch: int
    per_replica_batch: int

    @classmethod
    def plan(cls, healthy_slices: int, slices_per_data_shard: int,
             model_parallel: int, global_batch: int) -> "ElasticPlan":
        """Shrink the data axis to what the healthy slices support.

        Keeps the global batch by growing the per-replica batch where it
        divides; otherwise cuts the global batch to the nearest multiple
        below (the caller may rescale the learning rate by it)."""
        dp = max(healthy_slices // slices_per_data_shard, 1)
        if global_batch % dp == 0:
            per = global_batch // dp
            gb = global_batch
        else:
            per = max(global_batch // dp, 1)
            gb = per * dp
        return cls(data_parallel=dp, model_parallel=model_parallel,
                   global_batch=gb, per_replica_batch=per)


@dataclass
class SupervisorReport:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    remeshes: List[Tuple[int, int]] = field(default_factory=list)  # (step, dp)
    final_step: int = 0


class TrainSupervisor:
    """Restartable training state machine that takes injected failures.

    ``train_fn(state, step) -> state`` runs one train step. The state is
    saved and restored through ``ckpt``; after a failure the re-mesh plan
    goes to ``remesh_fn(plan, state) -> state`` if one is given.
    """

    def __init__(self, ckpt: CheckpointManager, monitor: HeartbeatMonitor,
                 slices_per_data_shard: int = 1, model_parallel: int = 1,
                 global_batch: int = 8, checkpoint_every: int = 50):
        self.ckpt = ckpt
        self.monitor = monitor
        self.spd = slices_per_data_shard
        self.mp = model_parallel
        self.gb = global_batch
        self.checkpoint_every = checkpoint_every
        self.report = SupervisorReport()

    def run(self, state: Any, train_fn: Callable[[Any, int], Any],
            start_step: int, total_steps: int,
            failure_injector: Optional[Callable[[int], Optional[int]]] = None,
            remesh_fn: Optional[Callable] = None
            ) -> Tuple[Any, SupervisorReport]:
        step = start_step
        while step < total_steps:
            failed_slice = failure_injector(step) if failure_injector else None
            if failed_slice is not None:
                self.monitor.fail(failed_slice)
            down = [n for n in self.monitor.rm.nodes.values()
                    if n.state is not NodeState.UP]
            if down:
                # recovery: restore the newest committed step, plan the
                # re-mesh over the healthy slices
                self.report.failures += 1
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state, extra = self.ckpt.restore(state)
                    step = int(extra.get("step", latest))
                    self.report.restores += 1
                plan = ElasticPlan.plan(
                    len(self.monitor.healthy_slices()), self.spd, self.mp,
                    self.gb)
                self.report.remeshes.append((step, plan.data_parallel))
                if remesh_fn is not None:
                    state = remesh_fn(plan, state)
                # repair: the down slices rejoin for the next steps
                for n in down:
                    self.monitor.rm.heartbeat(n.node_id, time.time())
            state = train_fn(state, step)
            step += 1
            self.report.steps_run += 1
            if step % self.checkpoint_every == 0:
                self.ckpt.save(step, state, extra={"step": step})
        self.ckpt.save(total_steps, state, extra={"step": total_steps})
        self.ckpt.wait()
        self.report.final_step = step
        return state, self.report

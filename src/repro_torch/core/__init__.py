"""Core: the paper's contribution — scheduler, latency model, multilevel
scheduling (Reuther et al., JPDC 2017). A copy of the reference's
``repro.core``; the executors that run real payloads are in
``core/executor.py``."""
from repro_torch.core.families import FAMILIES, GRID_ENGINE, INPROC, MESOS, SLURM, YARN, LatencyProfile
from repro_torch.core.faults import FaultPlane, FaultProfile, WallFaultArm
from repro_torch.core.job import Job, JobState, ResourceRequest, Task, TaskState
from repro_torch.core.latency_model import (
    ModelFit, delta_t, fit_power_law, total_runtime, utilization_approx,
    utilization_constant, utilization_variable)
from repro_torch.core.multilevel import MultilevelConfig, aggregate, map_reduce
from repro_torch.core.policies import (
    BackfillPolicy, BinPackingPolicy, FIFOPolicy, LocalityPolicy, make_policy)
from repro_torch.core.queues import QueueConfig, QueueManager
from repro_torch.core.resources import Node, NodeState, ResourceManager
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.simulator import EventLoop

__all__ = [
    "FAMILIES", "GRID_ENGINE", "INPROC", "MESOS", "SLURM", "YARN",
    "LatencyProfile", "FaultPlane", "FaultProfile", "WallFaultArm",
    "Job", "JobState", "ResourceRequest", "Task",
    "TaskState", "ModelFit", "delta_t", "fit_power_law", "total_runtime",
    "utilization_approx", "utilization_constant", "utilization_variable",
    "MultilevelConfig", "aggregate", "map_reduce", "BackfillPolicy",
    "BinPackingPolicy", "FIFOPolicy", "LocalityPolicy", "make_policy",
    "QueueConfig", "QueueManager", "Node", "NodeState", "ResourceManager",
    "Scheduler", "SchedulerConfig", "EventLoop",
]

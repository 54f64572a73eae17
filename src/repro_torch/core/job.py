"""Jobs and tasks: the part of the scheduler's data model the port uses.

A trimmed copy of the reference scheduler's ``Job``/``Task``. In serving a
request is a job array of one task, and the task is what holds a decode
lane; an executor (``core/executor.py``) runs a task's ``payload``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

_job_ids = itertools.count(1)


@dataclass
class ResourceRequest:
    """Per-task resource request: job slots on one node."""

    slots: int = 1


@dataclass
class Task:
    job_id: int
    index: int
    duration: float = 0.0               # simulated runtime (seconds)
    payload: Optional[Callable] = None  # real work, run by an executor
    request: ResourceRequest = field(default_factory=ResourceRequest)
    node_id: Optional[int] = None

    @property
    def key(self) -> Tuple[int, int]:
        return (self.job_id, self.index)


@dataclass
class Job:
    name: str = "job"
    job_id: int = field(default_factory=lambda: next(_job_ids))
    tasks: List[Task] = field(default_factory=list)

    @classmethod
    def array(cls, n_tasks: int, *, name: str = "job") -> "Job":
        """A job array of ``n_tasks`` independent one-slot tasks."""
        job = cls(name=name)
        job.tasks = [Task(job.job_id, i) for i in range(n_tasks)]
        return job

"""Standard Workload Format (SWF) trace reader/writer.

SWF (Feitelson's Parallel Workloads Archive format, also what AccaSim and
most HPC simulators consume) is line-oriented: `;`-prefixed header comments,
then one job per line with 18 whitespace-separated numeric fields.  Missing
or unknown values are -1 by convention.

Everything here is streaming: ``read_swf`` yields records one line at a
time, ``jobs_from_swf`` maps them to :class:`JobSpec`s lazily, so a
multi-gigabyte archive trace feeds the injector in O(1) memory.
"""
from __future__ import annotations

import io
from dataclasses import dataclass, fields
from pathlib import Path
from typing import IO, Iterable, Iterator, Optional, Union

from repro_torch.core.job import ResourceRequest
from repro_torch.workloads.spec import JobSpec

#: The 18 standard SWF fields, in column order.
SWF_FIELDS = (
    "job_number", "submit_time", "wait_time", "run_time",
    "allocated_processors", "avg_cpu_time", "used_memory",
    "requested_processors", "requested_time", "requested_memory",
    "status", "user_id", "group_id", "executable_number",
    "queue_number", "partition_number", "preceding_job_number",
    "think_time",
)


@dataclass
class SWFRecord:
    """One SWF line. Integer fields; avg_cpu_time may be fractional."""

    job_number: int = -1
    submit_time: float = 0.0
    wait_time: float = -1.0
    run_time: float = -1.0
    allocated_processors: int = -1
    avg_cpu_time: float = -1.0
    used_memory: int = -1
    requested_processors: int = -1
    requested_time: float = -1.0
    requested_memory: int = -1
    status: int = -1
    user_id: int = -1
    group_id: int = -1
    executable_number: int = -1
    queue_number: int = -1
    partition_number: int = -1
    preceding_job_number: int = -1
    think_time: float = -1.0

    @property
    def processors(self) -> int:
        """Best-available width: allocated, else requested, else 1."""
        if self.allocated_processors > 0:
            return self.allocated_processors
        if self.requested_processors > 0:
            return self.requested_processors
        return 1

    @property
    def duration(self) -> float:
        """Best-available runtime: actual, else requested estimate, else 0."""
        if self.run_time >= 0:
            return self.run_time
        if self.requested_time >= 0:
            return self.requested_time
        return 0.0

    def to_line(self) -> str:
        vals = []
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, float):
                # shortest exact representation: archive submit times reach
                # 1e7 s, which %g would round and break the read round-trip
                vals.append(str(int(v)) if v.is_integer() else repr(v))
            else:
                vals.append(str(v))
        return " ".join(vals)


_FLOAT_FIELDS = frozenset(
    ("submit_time", "wait_time", "run_time", "avg_cpu_time",
     "requested_time", "think_time"))


def parse_swf_line(line: str) -> Optional[SWFRecord]:
    """One record, or None for comments / blank lines / malformed rows."""
    line = line.strip()
    if not line or line.startswith(";"):
        return None
    parts = line.split()
    if len(parts) < len(SWF_FIELDS):
        return None
    rec = SWFRecord()
    try:
        for name, raw in zip(SWF_FIELDS, parts):
            setattr(rec, name,
                    float(raw) if name in _FLOAT_FIELDS else int(float(raw)))
    except ValueError:
        return None
    return rec


def read_swf(source: Union[str, Path, IO[str]]) -> Iterator[SWFRecord]:
    """Stream records from a path or an open text handle."""
    if isinstance(source, (str, Path)):
        with open(source, "r") as fh:
            yield from read_swf(fh)
        return
    for line in source:
        rec = parse_swf_line(line)
        if rec is not None:
            yield rec


def write_swf(records: Iterable[SWFRecord],
              dest: Union[str, Path, IO[str]],
              header: str = "") -> None:
    """Write records (round-trips with ``read_swf``)."""
    if isinstance(dest, (str, Path)):
        with open(dest, "w") as fh:
            write_swf(records, fh, header=header)
        return
    for line in header.splitlines():
        dest.write(f"; {line}\n")
    for rec in records:
        dest.write(rec.to_line() + "\n")


def jobs_from_swf(source: Union[str, Path, IO[str]], *,
                  gang: bool = False,
                  time_scale: float = 1.0,
                  max_jobs: int = 0) -> Iterator[JobSpec]:
    """Map a trace to JobSpecs: one job per record, one task per processor.

    ``gang=True`` makes each job a parallel (co-start) job, matching rigid
    MPI semantics; the default treats the processors as an array of
    independent tasks, which keeps wide traces on the scheduler's unit-slot
    fast path.  ``time_scale`` compresses/dilates both arrivals and runtimes
    (SWF archives span months; scaled replays keep the shape).  Records are
    assumed submit-time-ordered, as the SWF spec requires.
    """
    n = 0
    for rec in read_swf(source):
        if rec.status == 0 and rec.run_time <= 0:
            continue               # failed-at-submit rows carry no work
        yield JobSpec(
            arrival=rec.submit_time * time_scale,
            n_tasks=rec.processors,
            duration=max(rec.duration * time_scale, 0.0),
            request=ResourceRequest(),
            name=f"swf{rec.job_number}",
            user=f"u{rec.user_id}" if rec.user_id >= 0 else "user",
            queue="default",
            parallel=gang,
            meta={"swf_status": rec.status,
                  "swf_queue": rec.queue_number},
        )
        n += 1
        if max_jobs and n >= max_jobs:
            return


def specs_to_swf(specs: Iterable[JobSpec]) -> Iterator[SWFRecord]:
    """Inverse of ``jobs_from_swf`` for exporting synthetic streams."""
    for i, spec in enumerate(specs, start=1):
        yield SWFRecord(
            job_number=i,
            submit_time=spec.arrival,
            run_time=spec.duration,
            allocated_processors=spec.n_tasks,
            requested_processors=spec.n_tasks,
            requested_time=spec.duration,
            status=1,
        )

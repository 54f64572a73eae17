"""Workload subsystem: trace-driven + synthetic job sources, streamed into
the virtual-clock engine at million-task scale (paper's measurement method:
drive the scheduler with a parameterized workload, fit ΔT = t_s·n^α_s).

A copy of the reference's ``repro/workloads``: the same specs, the same
seeded draws in the same order, so a stream is equal spec for spec and a
run's virtual-time results are equal bit for bit
(``tests/test_torch_workloads.py``)."""
from repro_torch.workloads.injector import StreamingInjector
from repro_torch.workloads.metrics import MetricsTap, Reservoir, TimeSeries
from repro_torch.workloads.spec import JobSpec, materialize, validate_stream
from repro_torch.workloads.swf import (
    SWFRecord, jobs_from_swf, parse_swf_line, read_swf, specs_to_swf,
    write_swf)
from repro_torch.workloads.synthetic import (
    FAMILIES as SYNTHETIC_FAMILIES, FAULT_PROFILES, TASKSET_PARAMS,
    bursty_arrivals, constant_durations, constant_taskset, diurnal_arrivals,
    lognormal_durations, map_reduce_stream, mixed_shapes, pareto_durations,
    poisson_arrivals, synthetic_stream, zero_slot_shape)

__all__ = [
    "StreamingInjector", "MetricsTap", "Reservoir", "TimeSeries",
    "JobSpec", "materialize", "validate_stream",
    "SWFRecord", "jobs_from_swf", "parse_swf_line", "read_swf",
    "specs_to_swf", "write_swf",
    "SYNTHETIC_FAMILIES", "FAULT_PROFILES", "TASKSET_PARAMS",
    "bursty_arrivals",
    "constant_durations", "constant_taskset", "diurnal_arrivals",
    "lognormal_durations", "map_reduce_stream", "mixed_shapes",
    "pareto_durations", "poisson_arrivals", "synthetic_stream",
    "zero_slot_shape",
]

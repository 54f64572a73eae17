"""Observability plane of the port: flight recorder, metrics registry,
self-profiler, live dashboard.

Four layers, all stdlib-only, all zero-cost when not attached (the engine's
observation hooks are None-checked; an unobserved run pays one comparison
per event and nothing else):

* :class:`FlightRecorder` (``trace.py``) — bounded ring-buffer structured
  event trace of the full task lifecycle, bit-identical between the wave
  and per-event dispatch paths, exportable as Chrome-trace JSON.
* :class:`Registry` (``registry.py``) — named counters / gauges /
  histograms / series unifying the engine's scattered metric state;
  ``repro_torch.workloads.MetricsTap`` is a thin view over one.
* :class:`SelfProfiler` (``profile.py``) — wall-clock phase timers
  attributing the scheduler's *own* CPU time to admission / policy cycle /
  dispatch / completion / heartbeat sweep (the paper's t_s, measured, not
  modeled — see ``repro_torch.bench.self_latency``).
* :class:`Dashboard` (``dashboard.py``) — terminal renderer (and static
  HTML report) streaming registry series during long runs.

Copies of the reference's ``repro/obs`` with imports rewritten.
"""
from repro_torch.obs.dashboard import Dashboard
from repro_torch.obs.profile import SelfProfiler
from repro_torch.obs.registry import Counter, Gauge, Histogram, Registry
from repro_torch.obs.trace import FlightRecorder

__all__ = [
    "FlightRecorder", "Registry", "Counter", "Gauge", "Histogram",
    "SelfProfiler", "Dashboard",
]

"""Observability plane of the port: the metrics registry.

:class:`Registry` (``registry.py``) holds named counters, gauges,
histograms and series, unifying the engine's scattered metric state;
``repro_torch.workloads.MetricsTap`` is a thin view over one. A copy of
the reference's ``repro/obs/registry.py``; the reference's flight
recorder, self-profiler and dashboard are not in the port yet.
"""
from repro_torch.obs.registry import Counter, Gauge, Histogram, Registry

__all__ = ["Registry", "Counter", "Gauge", "Histogram"]

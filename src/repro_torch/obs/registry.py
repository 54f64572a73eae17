"""Metrics registry: named counters, gauges, histograms, time series.

One :class:`Registry` unifies what was previously scattered across
``MetricsTap`` internals, the scheduler's fault counters (``requeues``,
``quarantined``, ``lost_work_s``), the fault plane's injection ledger, and
``ResourceManager`` occupancy.  Instruments come in two flavors:

* **owned** — ``counter`` / ``histogram`` / ``series``: the registry holds
  the state and writers update it (``MetricsTap`` is a thin view over
  these — its hooks write registry instruments, its legacy attributes are
  reads of them);
* **bound** — ``gauge(name, fn)`` and the ``bind_*`` helpers: lazy reads
  of authoritative engine state, sampled only when a snapshot or dashboard
  frame asks.  Binding costs the engine nothing per event.

``snapshot()`` renders everything to plain JSON-ready values, so dashboards
and reports need no knowledge of instrument internals.

A copy of the reference's ``repro/obs/registry.py``;
``tests/test_torch_workloads.py`` holds its snapshots equal to the
reference's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]


class Counter:
    """Monotonic (by convention) scalar accumulator; float-friendly."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value: either ``set()`` explicitly or bound to a
    zero-argument callable reading authoritative state lazily."""

    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str, fn: Optional[Callable[[], object]] = None):
        self.name = name
        self._value = 0.0
        self._fn = fn

    def set(self, v) -> None:
        if self._fn is not None:
            raise TypeError(f"gauge {self.name!r} is bound to a callable")
        self._value = v

    def read(self):
        return self._fn() if self._fn is not None else self._value


class Histogram:
    """Reservoir-sampled distribution plus exact count / sum / max.

    ``sum`` accumulates one add at a time (never via partial sums) so a
    stream observed in the same order produces the bit-identical float —
    the property MetricsTap's wave/per-event equivalence rests on.
    """

    __slots__ = ("name", "count", "sum", "max", "_res")

    def __init__(self, name: str, size: int = 4096, seed: int = 0):
        # local import: workloads.metrics owns Reservoir (and its
        # sorted-view cache); obs reuses rather than re-implements it
        from repro_torch.workloads.metrics import Reservoir
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._res = Reservoir(size, seed)

    def add(self, x: float) -> None:
        self.count += 1
        self.sum += x
        if x > self.max:
            self.max = x
        self._res.add(x)

    def percentile(self, q: float) -> float:
        return self._res.percentile(q)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Registry:
    """Get-or-create instrument store with a stable (insertion) order."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    # ---------------------------------------------------------- factories
    def _get(self, name: str, cls, factory):
        m = self._metrics.get(name)
        if m is None:
            m = factory()
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str,
              fn: Optional[Callable[[], object]] = None) -> Gauge:
        g = self._get(name, Gauge, lambda: Gauge(name, fn))
        if fn is not None and g._fn is None:
            g._fn = fn              # late binding onto a declared gauge
        return g

    def histogram(self, name: str, size: int = 4096,
                  seed: int = 0) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(name, size, seed))

    def series(self, name: str, max_points: int = 2048):
        from repro_torch.workloads.metrics import TimeSeries
        return self._get(name, TimeSeries, lambda: TimeSeries(max_points))

    # ------------------------------------------------------------ reading
    def get(self, name: str):
        return self._metrics[name]

    def names(self) -> List[str]:
        return list(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """Render every instrument to plain values (JSON-ready)."""
        from repro_torch.workloads.metrics import TimeSeries
        out: Dict[str, object] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = m.read()
            elif isinstance(m, Histogram):
                out[name] = {"count": m.count, "mean": m.mean,
                             "p50": m.percentile(50), "p99": m.percentile(99),
                             "max": m.max}
            elif isinstance(m, TimeSeries):
                out[name] = list(m.points)
            else:                       # registered foreign object
                out[name] = repr(m)
        return out

    # ------------------------------------------------------------ binding
    def bind_scheduler(self, sch, prefix: str = "sched") -> "Registry":
        """Lazy gauges over the scheduler's authoritative counters."""
        for attr in ("dispatched", "completed", "requeues", "quarantined",
                     "lost_work_s", "active_jobs", "sched_clock"):
            self.gauge(f"{prefix}.{attr}",
                       (lambda s=sch, a=attr: getattr(s, a)))
        self.gauge(f"{prefix}.now", lambda s=sch: s.loop.now)
        return self

    def bind_resources(self, rm, prefix: str = "rm") -> "Registry":
        self.gauge(f"{prefix}.free_slots", rm.free_slots)
        self.gauge(f"{prefix}.total_slots", rm.total_slots)

        def occupancy() -> float:
            total = rm.total_slots()
            return 1.0 - rm.free_slots() / total if total else 0.0

        self.gauge(f"{prefix}.occupancy", occupancy)
        return self

    def bind_fault_plane(self, plane, prefix: str = "faults") -> "Registry":
        for kind in plane.injected:
            self.gauge(f"{prefix}.injected.{kind}",
                       (lambda p=plane, k=kind: p.injected[k]))
        self.gauge(f"{prefix}.recoveries", lambda p=plane: p.recoveries)
        self.gauge(f"{prefix}.false_positives",
                   lambda p=plane: p.false_positives)
        self.gauge(f"{prefix}.downtime_node_s",
                   lambda p=plane: p.summary()["downtime_node_s"])
        return self

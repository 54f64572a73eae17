"""Live dashboard: stdlib-only terminal renderer + static HTML report.

Streams a :class:`~repro_torch.obs.registry.Registry`'s instruments (and
a ``MetricsTap``'s bounded series) during long benchmark runs.  Wired into
``repro_torch.bench.workload_replay`` (``--dashboard`` / ``--html``) and
``repro_torch.bench.fault_replay`` (``--dashboard``).

Attachment is batch-only by design: the dashboard chains
``on_dispatch_batch`` / ``on_cycle`` / ``on_job_done`` — never the
per-task ``on_dispatch`` hook — so attaching it after a ``MetricsTap``
neither triggers the tap's clobber-replay (which would double-count) nor
knocks the engine off the wave-batched hot path.  Rendering is throttled
by *real* time (default 4 frames/s), so the per-event cost is one
``monotonic()`` read regardless of virtual-time event rates.

A copy of the reference's ``repro/obs/dashboard.py``; tests/test_torch_obs.py
holds its frames and HTML equal to the reference's on virtual runs.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.registry import Registry

__all__ = ["Dashboard"]

_SPARK = " ▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 48) -> str:
    """Render the last ``width`` values as a unicode sparkline."""
    if not values:
        return ""
    vals = values[-width:]
    lo = min(vals)
    hi = max(vals)
    span = hi - lo
    if span <= 0.0:
        return _SPARK[1] * len(vals)
    top = len(_SPARK) - 1
    return "".join(_SPARK[1 + int((v - lo) / span * (top - 1))]
                   for v in vals)


class Dashboard:
    """Attach to a Scheduler; frames render to ``out`` (default stderr).

    ``registry`` defaults to a fresh one bound to the scheduler and its
    ResourceManager at attach time; pass the tap's registry to surface its
    counters too.  ``tap`` (optional) supplies the bounded depth /
    utilization series for sparklines.
    """

    def __init__(self, registry: Optional[Registry] = None, *, tap=None,
                 out=None, fps: float = 4.0, width: int = 48):
        self.registry = registry if registry is not None else Registry()
        self.tap = tap
        self.out = out if out is not None else sys.stderr
        self.min_interval = 1.0 / fps if fps > 0.0 else 0.0
        self.width = width
        self.frames = 0
        self._sch = None
        self._chain_batch = None
        self._chain_cycle = None
        self._chain_done = None
        self._last = 0.0
        self._lines = 0                 # lines of the previous frame
        self._isatty = getattr(self.out, "isatty", lambda: False)()

    # ------------------------------------------------------------ attach
    def attach(self, sch) -> "Dashboard":
        if self._sch is not None:
            raise RuntimeError("Dashboard is already attached")
        self._sch = sch
        self.registry.bind_scheduler(sch).bind_resources(sch.rm)
        self._chain_batch = sch.on_dispatch_batch
        self._chain_cycle = sch.on_cycle
        self._chain_done = sch.on_job_done
        sch.on_dispatch_batch = self._on_batch
        sch.on_cycle = self._on_cycle
        sch.on_job_done = self._on_done
        return self

    def _on_batch(self, tasks, depths) -> None:
        if self._chain_batch is not None:
            self._chain_batch(tasks, depths)
        self._maybe_render()

    def _on_cycle(self, now, depth) -> None:
        if self._chain_cycle is not None:
            self._chain_cycle(now, depth)
        self._maybe_render()

    def _on_done(self, job) -> None:
        if self._chain_done is not None:
            self._chain_done(job)
        self._maybe_render()

    # ----------------------------------------------------------- render
    def _maybe_render(self) -> None:
        t = time.monotonic()
        if t - self._last < self.min_interval:
            return
        self._last = t
        self.render_frame()

    def render(self) -> str:
        """One frame as text (also the unit-testable surface)."""
        snap = self.registry.snapshot()
        lines = [f"── scheduler @ t={snap.get('sched.now', 0.0):,.2f}s "
                 f"(clock {snap.get('sched.sched_clock', 0.0):,.2f}s) ──"]
        row = []
        for key, label in (("sched.dispatched", "dispatched"),
                           ("sched.completed", "completed"),
                           ("sched.active_jobs", "active"),
                           ("sched.requeues", "requeues"),
                           ("sched.quarantined", "quarantined")):
            if key in snap:
                row.append(f"{label} {snap[key]:,}")
        if "rm.occupancy" in snap:
            row.append(f"occupancy {snap['rm.occupancy']:.1%}")
        lines.append("  ".join(row))
        faults = [f"{k.rsplit('.', 1)[1]} {v}" for k, v in snap.items()
                  if k.startswith("faults.injected.") and v]
        if faults:
            lines.append("faults: " + "  ".join(faults))
        tap = self.tap
        if tap is not None:
            w = self.width
            depth = [v for _, v in tap.depth_series.points]
            util = [v for _, v in tap.util_series.points]
            if depth:
                lines.append(f"depth {sparkline(depth, w)} "
                             f"{depth[-1]:,.0f}")
            if util:
                lines.append(f"util  {sparkline(util, w)} {util[-1]:.1%}")
            lines.append(
                f"latency mean {tap.latency_sum / max(tap.dispatches, 1):.4f}s"
                f"  max {tap.latency_max:.4f}s  jobs done {tap.jobs_done:,}")
        return "\n".join(lines)

    def render_frame(self) -> None:
        frame = self.render()
        n = frame.count("\n") + 1
        if self._isatty and self._lines:
            # rewrite the previous frame in place
            self.out.write(f"\x1b[{self._lines}F\x1b[J")
        self.out.write(frame + "\n")
        self.out.flush()
        self._lines = n
        self.frames += 1

    def finish(self) -> None:
        """Force-render the terminal state (end-of-run frame)."""
        self._last = 0.0
        self.render_frame()

    # -------------------------------------------------------------- html
    def export_html(self, path: str, title: str = "scheduler run") -> None:
        """Static report: final snapshot table + SVG series charts."""
        snap = self.registry.snapshot()
        rows = "\n".join(
            f"<tr><td>{k}</td><td>{v if not isinstance(v, float) else round(v, 6)}</td></tr>"
            for k, v in sorted(snap.items())
            if not isinstance(v, (list, dict)))
        charts = []
        tap = self.tap
        series: List[Tuple[str, List[Tuple[float, float]]]] = []
        if tap is not None:
            series.append(("queue depth", tap.depth_series.points))
            series.append(("utilization", tap.util_series.points))
            series.append(("requeues", tap.requeue_series.points))
        for name, pts in series:
            if pts:
                charts.append(_svg_chart(name, pts))
        html = (
            "<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{title}</title>"
            "<style>body{font-family:monospace;margin:2em}"
            "table{border-collapse:collapse}"
            "td{border:1px solid #ccc;padding:2px 8px}"
            "svg{background:#fafafa;border:1px solid #ccc;margin:1em 0}"
            "</style></head><body>"
            f"<h1>{title}</h1>" + "".join(charts)
            + f"<h2>final snapshot</h2><table>{rows}</table>"
            "</body></html>")
        with open(path, "w") as fh:
            fh.write(html)


def _svg_chart(name: str, pts: List[Tuple[float, float]],
               w: int = 640, h: int = 120) -> str:
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    xs_span = (x1 - x0) or 1.0
    ys_span = (y1 - y0) or 1.0
    coords = " ".join(
        f"{(x - x0) / xs_span * (w - 10) + 5:.1f},"
        f"{h - 5 - (y - y0) / ys_span * (h - 10):.1f}"
        for x, y in pts)
    return (f"<h2>{name}</h2><svg width='{w}' height='{h}' "
            f"viewBox='0 0 {w} {h}'><polyline points='{coords}' "
            "fill='none' stroke='#0074d9' stroke-width='1'/>"
            f"<text x='8' y='14' font-size='10'>max {y1:g}</text>"
            f"<text x='8' y='{h - 8}' font-size='10'>min {y0:g}</text>"
            "</svg>")

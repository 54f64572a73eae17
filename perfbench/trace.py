"""The traced run: torch.profiler over the window, read back from its
Chrome trace.

``profiled(path)`` profiles the block (CPU and CUDA activities) inside a
``bench.window`` range, writes the trace to ``path`` and returns it read
as a ``Trace``: the device's operations (kernels, copies, sets) with
their launch times, the host's ranges (``record_function`` annotations,
the benchmark's ``bench.*`` and the program's own such as
``train_step.optimizer``) and top-level operators, all on the profiler's
clock (microseconds).
"""
from __future__ import annotations

import contextlib
import json
from bisect import bisect_right
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from perfbench import stats

WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window: Tuple[float, float]                       # us
    ops: List[Tuple[str, float, float, Optional[float]]]  # name, start, end, launch
    ranges: List[Tuple[str, float, float]]            # annotations
    host_ops: List[Tuple[str, float, float, int]]     # cpu ops, with tid
    main_tid: Optional[int] = None
    _busy: Optional[List[Tuple[float, float]]] = field(default=None,
                                                       repr=False)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self) -> List[Tuple[float, float]]:
        if self._busy is None:
            self._busy = stats.union(stats.clip(
                ((a, b) for _, a, b, _ in self.ops), *self.window))
        return self._busy

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def ops_named(self, *parts: str):
        """Device operations whose name holds one of ``parts``."""
        return [o for o in self.ops if any(p in o[0] for p in parts)]

    def ops_launched_in(self, range_name: str):
        """Device operations launched inside a host range of that name."""
        spans = sorted((a, b) for n, a, b in self.ranges if n == range_name)
        starts = [a for a, _ in spans]
        out = []
        for op in self.ops:
            t = op[3]
            if t is None:
                continue
            i = bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                out.append(op)
        return out

    def range_count(self, range_name: str) -> int:
        return sum(1 for n, _, _ in self.ranges if n == range_name)

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time in the window."""
        total: Dict[str, float] = {}
        lo, hi = self.window
        for name, a, b, _ in self.ops:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return [[k[:200], v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps of the device in the window, each named
        by what the host's main thread was doing when it began: the
        innermost ``bench.*`` or program range and the outermost operator
        covering that moment."""
        gaps = sorted(stats.gaps(self.busy(), *self.window),
                      key=lambda g: g[0] - g[1])[:n]
        return [[self._doing(a), (b - a) / 1e6] for a, b in gaps]

    def _doing(self, t: float) -> str:
        inner = [r for r in self.ranges if r[1] <= t <= r[2]]
        where = min(inner, key=lambda r: r[2] - r[1])[0] if inner else "-"
        outer = [o for o in self.host_ops if o[1] <= t <= o[2]
                 and (self.main_tid is None or o[3] == self.main_tid)]
        what = (max(outer, key=lambda o: o[2] - o[1])[0] if outer
                else "python")
        return f"{where}: {what}"[:200]


def read(path: Path) -> Trace:
    """A Chrome trace written by torch.profiler, read back."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    launches: Dict[int, float] = {}
    ops, ranges, host_ops = [], [], []
    window = None
    main_tid = None
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[int(args["correlation"])] = ts
        elif cat in _DEVICE_CATS:
            device.append((e["name"], ts, ts + dur, args.get("correlation")))
        elif cat == "user_annotation":
            ranges.append((e["name"], ts, ts + dur))
            if e["name"] == WINDOW:
                window = (ts, ts + dur)
                main_tid = e.get("tid")
        elif cat == "cpu_op":
            host_ops.append((e["name"], ts, ts + dur, e.get("tid")))
    if window is None:
        raise ValueError(f"{path}: no {WINDOW} range in the trace")
    for name, a, b, corr in device:
        ops.append((name, a, b,
                    launches.get(int(corr)) if corr is not None else None))
    return Trace(window, ops, ranges, host_ops, main_tid)


@contextlib.contextmanager
def profiled(path: Path, out: dict, cuda: bool):
    """Profile the block inside a ``bench.window`` range; on exit write
    the trace to ``path`` and put it, read, in ``out["trace"]``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield
        if cuda:
            import torch

            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    out["trace"] = read(path)

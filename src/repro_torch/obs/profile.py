"""Self-profiler: wall-clock phase timers for the scheduler's own CPU time.

The paper characterizes a scheduler by its *measured* marginal latency; the
companion study (Reuther et al., "Scheduler Technologies in Support of High
Performance Data Analysis") shows that what separates schedulers at short
job durations is where that time goes — admission, policy cycle, dispatch,
completion handling, failure detection.  This module attributes our own
engine's real (``perf_counter``) time to those phases.

Mechanics: the profiler wraps a fixed set of scheduler entry points as
*instance* attributes (internal calls and event-loop callbacks resolve
``self._cycle`` etc. through the instance, so every path is covered;
``detach`` deletes the instance attributes, restoring the class methods).
Phases nest — ``_finish_wave`` retires jobs whose ``on_job_done`` may
submit new work — so a frame stack subtracts child time from the enclosing
frame: reported times are **self** times, summing to total engine time
without double counting.

Overhead control (Byun et al.: instrumentation must be O(1)-amortized or it
perturbs short-job regimes): ``stride=N`` times only every Nth call per
phase, scaling the sampled self time by N — an unbiased estimate when call
costs are i.i.d. within a phase.  ``stride=1`` (default) is exact.

A copy of the reference's ``repro/obs/profile.py``, but ``attach`` checks
every entry point of ``_PHASE_OF`` once and refuses a scheduler that lacks
one (the reference skips it), so a renamed method cannot drop out of the
report unnoticed. Under ``TorchDispatchExecutor`` the executor runs inside
``_dispatch`` (payload and device wait); ``_task_end`` nests in it and is
charged to completion.
"""
from __future__ import annotations

import time
from typing import Dict, List

__all__ = ["SelfProfiler"]

#: scheduler entry point -> phase label.  ``_cycle_wave`` re-labels the
#: wave path's bulk dispatch out of the surrounding policy cycle so the
#: cycle/dispatch split is comparable across engines.
_PHASE_OF = (
    ("submit", "admission"),
    ("_cycle", "cycle"),
    ("_cycle_wave", "dispatch"),
    ("_cycle_arena", "dispatch"),
    ("_dispatch", "dispatch"),
    ("_task_end", "completion"),
    ("_finish_wave", "completion"),
    ("_finish_arena", "completion"),
    ("_heartbeat_sweep", "sweep"),
)

PHASES = ("admission", "cycle", "dispatch", "completion", "sweep")


class PhaseStat:
    __slots__ = ("calls", "sampled", "self_s")

    def __init__(self):
        self.calls = 0
        self.sampled = 0
        self.self_s = 0.0


class SelfProfiler:
    """Attach to a Scheduler; read :meth:`report` after the run."""

    def __init__(self, stride: int = 1):
        if stride < 1:
            raise ValueError("stride must be >= 1")
        self.stride = stride
        self.stats: Dict[str, PhaseStat] = {p: PhaseStat() for p in PHASES}
        self._stack: List[List[float]] = []   # child-time accumulators
        self._sch = None
        self._wrapped: List[str] = []

    # ------------------------------------------------------------ attach
    def attach(self, sch) -> "SelfProfiler":
        if self._sch is not None:
            raise RuntimeError("SelfProfiler is already attached")
        missing = [attr for attr, _ in _PHASE_OF
                   if not callable(getattr(sch, attr, None))]
        if missing:
            raise AttributeError(f"{type(sch).__name__} lacks the profiled "
                                 f"entry points {missing}")
        self._sch = sch
        for attr, phase in _PHASE_OF:
            fn = getattr(sch, attr)
            setattr(sch, attr, self._wrap(fn, self.stats[phase]))
            self._wrapped.append(attr)
        return self

    def detach(self) -> "SelfProfiler":
        sch = self._sch
        if sch is None:
            return self
        for attr in self._wrapped:
            # deleting the instance attribute restores the class method
            try:
                delattr(sch, attr)
            except AttributeError:
                pass
        self._wrapped.clear()
        self._sch = None
        return self

    def _wrap(self, fn, st: PhaseStat):
        stride = self.stride
        stack = self._stack
        pc = time.perf_counter

        def timed(*args, **kw):
            st.calls += 1
            if st.calls % stride:        # unsampled call: zero added cost
                return fn(*args, **kw)
            frame = [0.0]
            stack.append(frame)
            t0 = pc()
            try:
                return fn(*args, **kw)
            finally:
                dt = pc() - t0
                stack.pop()
                st.sampled += 1
                st.self_s += (dt - frame[0]) * stride
                if stack:
                    # inclusive time charges the enclosing sampled frame,
                    # whatever its phase — self times never double count
                    stack[-1][0] += dt
        return timed

    # ----------------------------------------------------------- reading
    @property
    def total_s(self) -> float:
        return sum(st.self_s for st in self.stats.values())

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per-phase ``{calls, sampled, self_s, fraction}`` (JSON-ready)."""
        total = self.total_s
        out: Dict[str, Dict[str, float]] = {}
        for phase in PHASES:
            st = self.stats[phase]
            out[phase] = {
                "calls": st.calls,
                "sampled": st.sampled,
                "self_s": st.self_s,
                "fraction": st.self_s / total if total > 0.0 else 0.0,
            }
        return out

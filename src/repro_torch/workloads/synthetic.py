"""Seeded synthetic workload generators.

Two layers:

* primitives — arrival processes (Poisson, bursty on/off, diurnal NHPP via
  thinning), duration samplers (constant, lognormal, bounded Pareto), and
  job-shape mixes (arrays, gangs, zero-slot license jobs);
* families — named zero-config streams (``FAMILIES``) used by the replay CLI
  and CI smoke, plus the paper's constant-time task sets generalized to
  arbitrary (t, n, P) with optional wave-splitting for million-task runs.

Everything is a generator of :class:`JobSpec` in arrival order, driven by a
single ``random.Random(seed)`` — same seed, same stream, byte for byte
(pinned by the reference's tests/test_workloads.py, which also runs
against this copy through tests/test_torch_ref_workloads.py).
"""
from __future__ import annotations

import itertools
import math
import random
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

from repro_torch.core.faults import FaultProfile
from repro_torch.core.job import ResourceRequest
from repro_torch.workloads.spec import JobSpec

DurationSampler = Callable[[random.Random], float]


# ---------------------------------------------------------------- arrivals
def poisson_arrivals(rate: float, *, start: float = 0.0,
                     rng: Optional[random.Random] = None,
                     seed: int = 0) -> Iterator[float]:
    """Homogeneous Poisson process: Exp(1/rate) interarrivals."""
    rng = rng or random.Random(seed)
    t = start
    while True:
        t += rng.expovariate(rate)
        yield t


def bursty_arrivals(rate_on: float, rate_off: float, *,
                    on_len: float = 60.0, off_len: float = 240.0,
                    start: float = 0.0,
                    rng: Optional[random.Random] = None,
                    seed: int = 0) -> Iterator[float]:
    """On/off modulated Poisson: bursts at ``rate_on``, lulls at ``rate_off``.

    Phase boundaries are deterministic (fixed on/off lengths); arrivals
    within a phase are Poisson at that phase's rate.  A draw that crosses
    the phase boundary is restarted *at* the boundary under the next
    phase's rate — exact for piecewise-constant-rate processes (the
    exponential is memoryless), and what keeps a long lull draw from
    swallowing the bursts that follow it (rate_off=0 is a silent lull, not
    the end of the stream).
    """
    rng = rng or random.Random(seed)
    t = start
    period = on_len + off_len
    while True:
        while True:
            phase = (t - start) % period
            on = phase < on_len
            rate = rate_on if on else rate_off
            bound = on_len if on else period
            gap = rng.expovariate(max(rate, 1e-12))
            if phase + gap < bound:
                t += gap
                break
            t += bound - phase          # cross into the next phase, redraw
        yield t


def diurnal_arrivals(base_rate: float, *, amplitude: float = 0.8,
                     period: float = 86400.0, start: float = 0.0,
                     rng: Optional[random.Random] = None,
                     seed: int = 0) -> Iterator[float]:
    """Nonhomogeneous Poisson with rate(t) = base·(1 + a·sin(2πt/T)),
    sampled by Lewis-Shedler thinning against the peak rate."""
    rng = rng or random.Random(seed)
    peak = base_rate * (1.0 + abs(amplitude))
    t = start
    while True:
        t += rng.expovariate(peak)
        rate = base_rate * (1.0 + amplitude * math.sin(2 * math.pi * t / period))
        if rng.random() * peak <= max(rate, 0.0):
            yield t


# --------------------------------------------------------------- durations
def constant_durations(t: float) -> DurationSampler:
    return lambda rng: t


def lognormal_durations(median: float, sigma: float = 1.0) -> DurationSampler:
    """Heavy-ish tail; median-parameterized (mu = ln median)."""
    mu = math.log(max(median, 1e-12))
    return lambda rng: rng.lognormvariate(mu, sigma)


def pareto_durations(alpha: float = 1.5, xm: float = 1.0,
                     cap: float = 3600.0) -> DurationSampler:
    """Bounded Pareto: the paper's short-task regime with a straggler tail."""
    return lambda rng: min(xm * rng.paretovariate(alpha), cap)


# ------------------------------------------------------------- job shapes
def array_shape(n_tasks: int = 4) -> Callable[[random.Random], JobSpec]:
    return lambda rng: JobSpec(n_tasks=n_tasks)


def gang_shape(width: int = 8) -> Callable[[random.Random], JobSpec]:
    return lambda rng: JobSpec(n_tasks=width, parallel=True)


def zero_slot_shape(license_name: str = "lic") -> Callable[[random.Random], JobSpec]:
    """License-only job: occupies no slot, gates on a consumable (§3.2.4)."""
    return lambda rng: JobSpec(
        n_tasks=1,
        request=ResourceRequest(slots=0, licenses=(license_name,)))


def mixed_shapes(mix: Sequence[Tuple[float, Callable[[random.Random], JobSpec]]]
                 ) -> Callable[[random.Random], JobSpec]:
    """Weighted choice over shape factories."""
    total = sum(w for w, _ in mix)
    def pick(rng: random.Random) -> JobSpec:
        r = rng.random() * total
        for w, factory in mix:
            r -= w
            if r <= 0:
                return factory(rng)
        return mix[-1][1](rng)
    return pick


# ------------------------------------------------------------ composition
def synthetic_stream(*, seed: int = 0,
                     arrivals: str = "poisson",
                     rate: float = 10.0,
                     durations: Optional[DurationSampler] = None,
                     shape: Optional[Callable[[random.Random], JobSpec]] = None,
                     n_jobs: int = 1000,
                     name: str = "syn") -> Iterator[JobSpec]:
    """Compose (arrival process × duration sampler × shape mix) into a
    bounded stream of ``n_jobs`` specs, all drawn from one seeded RNG."""
    rng = random.Random(seed)
    if arrivals == "poisson":
        times = poisson_arrivals(rate, rng=rng)
    elif arrivals == "bursty":
        times = bursty_arrivals(rate * 4, rate / 4, rng=rng)
    elif arrivals == "diurnal":
        times = diurnal_arrivals(rate, rng=rng)
    else:
        raise ValueError(f"unknown arrival process: {arrivals!r}")
    durations = durations or constant_durations(1.0)
    shape = shape or array_shape(4)
    for i, t in zip(range(n_jobs), times):
        spec = shape(rng)
        spec.arrival = t
        spec.duration = durations(rng)
        spec.name = f"{name}{i}"
        spec.user = f"u{rng.randrange(16)}"
        yield spec


def map_reduce_stream(*, seed: int = 0, rate: float = 2.0,
                      n_stages: int = 200, map_tasks: int = 16,
                      map_duration: Optional[DurationSampler] = None,
                      reduce_duration: Optional[DurationSampler] = None
                      ) -> Iterator[JobSpec]:
    """Two-stage DAG family: each stage is a map array followed by a
    1-task reduce that depends on it (LLMapReduce shape, paper §5)."""
    rng = random.Random(seed)
    times = poisson_arrivals(rate, rng=rng)
    map_duration = map_duration or lognormal_durations(2.0, 0.5)
    reduce_duration = reduce_duration or constant_durations(1.0)
    for i, t in zip(range(n_stages), times):
        yield JobSpec(arrival=t, n_tasks=map_tasks,
                      duration=map_duration(rng),
                      name=f"map{i}", user=f"u{rng.randrange(16)}")
        yield JobSpec(arrival=t, n_tasks=1,
                      duration=reduce_duration(rng),
                      name=f"reduce{i}", depends_on_prev=(1,))


# -------------------------------------------------- paper-grid task sets
def constant_taskset(t: float, n: int, P: int, *,
                     wave_tasks: int = 0,
                     name: str = "taskset",
                     arrival: float = 0.0,
                     max_restarts: int = 0,
                     failure_policy: str = "retry") -> Iterator[JobSpec]:
    """The paper's constant-time task set generalized to arbitrary (t, n, P):
    n·P tasks of duration t submitted at one instant.

    ``wave_tasks=0`` emits the paper's protocol exactly — a single job array
    of n·P tasks (what Table 9 submits).  ``wave_tasks=k`` splits the set
    into ⌈nP/k⌉ arrays arriving at the same instant, so the streaming
    injector can bound materialized tasks to O(active · k) — the only way a
    24M-task set (n=240, P=102,400) fits in memory.  Splitting changes the
    queue-depth the latency model charges (fewer visible pending tasks), so
    scaled-grid artifacts record the wave size they ran with.
    """
    total = n * P
    if wave_tasks <= 0 or wave_tasks >= total:
        yield JobSpec(arrival=arrival, n_tasks=total, duration=t,
                      name=f"{name}-{n}x{P}", max_restarts=max_restarts,
                      failure_policy=failure_policy)
        return
    emitted = 0
    for w in itertools.count():
        k = min(wave_tasks, total - emitted)
        if k <= 0:
            return
        yield JobSpec(arrival=arrival, n_tasks=k, duration=t,
                      name=f"{name}-{n}x{P}-w{w}", max_restarts=max_restarts,
                      failure_policy=failure_policy)
        emitted += k


#: Paper Table 9 sets: name -> (t seconds, n tasks/processor).
TASKSET_PARAMS: Dict[str, Tuple[float, int]] = {
    "rapid": (1.0, 240),
    "fast": (5.0, 48),
    "medium": (30.0, 8),
    "long": (60.0, 4),
}


# ------------------------------------------------------- named families
def poisson_family(seed: int, n_jobs: int, P: int,
                   tasks_per_job: int = 4) -> Iterator[JobSpec]:
    """The baseline family; public because the replay CLI exposes its array
    width (every parameter lives here, so CLI and FAMILIES cannot drift)."""
    return synthetic_stream(seed=seed, arrivals="poisson", rate=P / 8.0,
                            durations=constant_durations(1.0),
                            shape=array_shape(tasks_per_job), n_jobs=n_jobs,
                            name="poisson")


def _fam_bursty(seed: int, n_jobs: int, P: int) -> Iterator[JobSpec]:
    return synthetic_stream(seed=seed, arrivals="bursty", rate=P / 8.0,
                            durations=constant_durations(1.0),
                            shape=array_shape(4), n_jobs=n_jobs,
                            name="bursty")


def _fam_diurnal(seed: int, n_jobs: int, P: int) -> Iterator[JobSpec]:
    return synthetic_stream(seed=seed, arrivals="diurnal", rate=P / 8.0,
                            durations=constant_durations(1.0),
                            shape=array_shape(4), n_jobs=n_jobs,
                            name="diurnal")


def _fam_heavy_tail(seed: int, n_jobs: int, P: int) -> Iterator[JobSpec]:
    return synthetic_stream(seed=seed, arrivals="poisson", rate=P / 16.0,
                            durations=pareto_durations(1.3, 0.5, 600.0),
                            shape=array_shape(4), n_jobs=n_jobs,
                            name="heavy")


def _fam_gang_mix(seed: int, n_jobs: int, P: int) -> Iterator[JobSpec]:
    shape = mixed_shapes(((0.7, array_shape(4)),
                          (0.3, gang_shape(max(P // 16, 2)))))
    return synthetic_stream(seed=seed, arrivals="poisson", rate=P / 16.0,
                            durations=lognormal_durations(2.0, 0.8),
                            shape=shape, n_jobs=n_jobs, name="gangmix")


def _fam_license_mix(seed: int, n_jobs: int, P: int) -> Iterator[JobSpec]:
    shape = mixed_shapes(((0.8, array_shape(4)),
                          (0.2, zero_slot_shape("lic"))))
    return synthetic_stream(seed=seed, arrivals="poisson", rate=P / 16.0,
                            durations=constant_durations(2.0),
                            shape=shape, n_jobs=n_jobs, name="licmix")


def _fam_mapreduce(seed: int, n_jobs: int, P: int) -> Iterator[JobSpec]:
    return map_reduce_stream(seed=seed, rate=max(P / 64.0, 0.5),
                             n_stages=max(n_jobs // 2, 1),
                             map_tasks=max(P // 8, 2))


#: Named fault regimes for the fault plane (virtual seconds, per-node MTBF)
#: — the chaos-side analogue of the workload FAMILIES below.  Keys name
#: the regimes ``repro_torch.bench.fault_replay`` sweeps from.
FAULT_PROFILES: Dict[str, FaultProfile] = {
    # rare independent crashes, unexceptional repair times
    "calm": FaultProfile(name="calm", mtbf=20000.0, mttr=120.0),
    # heavy churn: every node crashes often enough that most runs see many
    "churn": FaultProfile(name="churn", mtbf=2000.0, mttr=60.0),
    # correlated rack outages: 32-node failure domains die as a unit
    "rack_outage": FaultProfile(name="rack_outage", domain_size=32,
                                domain_mtbf=20000.0, domain_mttr=300.0),
    # transient flaps: frequent, but back within seconds
    "flaky": FaultProfile(name="flaky", flap_mtbf=4000.0, flap_mttr=5.0),
    # silent deaths only: detection waits on heartbeat sweeps
    "silent": FaultProfile(name="silent", mtbf=4000.0, mttr=120.0,
                           silent_fraction=1.0),
    # heartbeat loss without death: sweeps requeue live work
    "mute": FaultProfile(name="mute", mute_mtbf=4000.0, mute_mttr=45.0),
    # degraded nodes: payloads stretch 4x during degradation windows
    "degraded": FaultProfile(name="degraded", degrade_mtbf=4000.0,
                             degrade_mttr=240.0, degrade_factor=4.0),
    # everything at once (integration chaos)
    "kitchen_sink": FaultProfile(name="kitchen_sink", mtbf=6000.0,
                                 mttr=90.0, silent_fraction=0.25,
                                 flap_mtbf=8000.0, flap_mttr=5.0,
                                 domain_size=32, domain_mtbf=40000.0,
                                 domain_mttr=300.0, degrade_mtbf=10000.0,
                                 degrade_mttr=240.0, degrade_factor=4.0),
}


#: name -> builder(seed, n_jobs, P) for the replay CLI / smoke tests.
FAMILIES: Dict[str, Callable[[int, int, int], Iterator[JobSpec]]] = {
    "poisson": poisson_family,
    "bursty": _fam_bursty,
    "diurnal": _fam_diurnal,
    "heavy_tail": _fam_heavy_tail,
    "gang_mix": _fam_gang_mix,
    "license_mix": _fam_license_mix,
    "mapreduce": _fam_mapreduce,
}

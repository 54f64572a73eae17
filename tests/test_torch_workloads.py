"""The port's workload subsystem (``repro_torch.workloads``) and metrics
registry (``repro_torch.obs``) against the reference's, with tolerance 0:
the same seeded streams spec for spec, the same SWF records and text, and
the same virtual-time runs through ``StreamingInjector`` and
``MetricsTap``, compared field by field."""
import dataclasses
import io
import random
from pathlib import Path

import pytest

import repro.obs as ref_obs
import repro.workloads as ref_w
import repro.workloads.synthetic as ref_syn
import repro_torch.obs as port_obs
import repro_torch.workloads as port_w
import repro_torch.workloads.synthetic as port_syn
from torch_sched_parity import PORT, REF, fast_profile, signature

FIXTURE = Path(__file__).parent / "fixtures" / "sample.swf"
W = {"reference": ref_w, "port": port_w}
SYN = {"reference": ref_syn, "port": port_syn}
OBS = {"reference": ref_obs, "port": port_obs}
CORE = {"reference": REF, "port": PORT}


def _spec_fields(spec):
    """A spec as plain values (its request as a dict: each package has
    its own ResourceRequest class)."""
    return dataclasses.asdict(spec)


def _both(fn, *args, **kwargs):
    return [fn(side, *args, **kwargs) for side in ("reference", "port")]


# ------------------------------------------------------------- streams
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("family", sorted(ref_syn.FAMILIES))
def test_family_streams_are_equal(family, seed):
    assert sorted(port_syn.FAMILIES) == sorted(ref_syn.FAMILIES)
    ref, port = _both(lambda side: [
        _spec_fields(s) for s in SYN[side].FAMILIES[family](seed, 300, 64)])
    assert len(ref) >= 300 and port == ref


@pytest.mark.parametrize("wave_tasks", [0, 1000, 4096])
def test_constant_taskset_waves_are_equal(wave_tasks):
    ref, port = _both(lambda side: [
        _spec_fields(s) for s in SYN[side].constant_taskset(
            1.0, 24, 1408, wave_tasks=wave_tasks, max_restarts=2)])
    assert port == ref
    assert sum(s["n_tasks"] for s in port) == 24 * 1408


def test_task_set_params_are_equal():
    assert port_syn.TASKSET_PARAMS == ref_syn.TASKSET_PARAMS
    assert port_w.MetricsTap.__init__.__defaults__ == \
        ref_w.MetricsTap.__init__.__defaults__


# ------------------------------------------------------ fault profiles
def _scaled(profile, factor):
    """``profile`` with every rate's time scale (mtbf, mttr) times
    ``factor``: the same regime, compressed to a short run."""
    return dataclasses.replace(profile, **{
        f.name: getattr(profile, f.name) * factor
        for f in dataclasses.fields(profile)
        if f.name.endswith(("mtbf", "mttr"))})


def _fault_run(side, name, seed):
    m, w = CORE[side], W[side]
    profile = _scaled(w.FAULT_PROFILES[name], 0.001)
    rm = m.ResourceManager()
    rm.add_nodes(128, slots=1)
    cfg = m.SchedulerConfig(heartbeat_interval=1.0, retry_backoff=0.25,
                            quarantine_after=3)
    s = m.Scheduler(rm, profile=fast_profile(m), config=cfg)
    jobs = []
    submit = s.submit
    s.submit = lambda j: (jobs.append(j), submit(j))[1]
    tap = w.MetricsTap()
    src = (dataclasses.replace(spec, max_restarts=4)
           for spec in w.synthetic_stream(seed=seed, n_jobs=400, rate=20.0))
    inj = w.StreamingInjector(s, src, tap=tap)
    plane = m.FaultPlane(s, profile, seed=seed)
    inj.run()
    return {"sig": signature(s, jobs), "tap": tap.summary(),
            "plane": plane.summary()}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", sorted(ref_syn.FAULT_PROFILES))
def test_fault_profiles_run_equal(name, seed):
    assert sorted(port_syn.FAULT_PROFILES) == sorted(ref_syn.FAULT_PROFILES)
    assert dataclasses.asdict(port_syn.FAULT_PROFILES[name]) == \
        dataclasses.asdict(ref_syn.FAULT_PROFILES[name])
    ref, port = _both(_fault_run, name, seed)
    assert port == ref
    assert sum(port["plane"]["injected"].values()) > 0


# ------------------------------------------------------------------ SWF
def test_swf_fixture_round_trip_is_equal():
    ref_recs = list(ref_w.read_swf(FIXTURE))
    port_recs = list(port_w.read_swf(FIXTURE))
    assert [dataclasses.asdict(r) for r in port_recs] == \
        [dataclasses.asdict(r) for r in ref_recs]
    texts = []
    for w, recs in ((ref_w, ref_recs), (port_w, port_recs)):
        buf = io.StringIO()
        w.write_swf(recs, buf, header="round trip\nsecond line")
        texts.append(buf.getvalue())
        again = list(w.read_swf(io.StringIO(buf.getvalue())))
        assert [dataclasses.asdict(r) for r in again] == \
            [dataclasses.asdict(r) for r in recs]
    assert texts[1] == texts[0]
    ref, port = _both(lambda side: [
        _spec_fields(s) for s in W[side].jobs_from_swf(FIXTURE)])
    assert port == ref and len(port) == 11
    ref, port = _both(lambda side: [
        dataclasses.asdict(r) for r in W[side].specs_to_swf(
            SYN[side].FAMILIES["heavy_tail"](3, 40, 32))])
    assert port == ref


# ------------------------------------------------------------ injection
def _inject(side, *, cap, wave, transform, family="gang_mix", P=48):
    m, w = CORE[side], W[side]
    rm = m.ResourceManager()
    rm.add_nodes(P, slots=1)
    rm.add_license("lic", 4)
    s = m.Scheduler(rm, profile=fast_profile(m),
                    config=m.SchedulerConfig(wave_batching=wave))
    jobs = []
    submit = s.submit
    s.submit = lambda j: (jobs.append(j), submit(j))[1]
    tx = None
    if transform:
        tx = lambda job: m.aggregate(  # noqa: E731
            job, slots=P, cfg=m.multilevel.MultilevelConfig(mode="mimo"))
    tap = w.MetricsTap(reservoir=64, max_points=32)
    inj = w.StreamingInjector(s, SYN[side].FAMILIES[family](4, 120, P),
                              max_active_jobs=cap, transform=tx, tap=tap)
    inj.run()
    assert inj.drained
    return {"sig": signature(s, jobs), "tap": tap.summary(),
            "counts": (inj.submitted_jobs, inj.submitted_tasks,
                       inj.peak_active_jobs)}


@pytest.mark.parametrize("family", ["poisson", "gang_mix", "license_mix",
                                    "mapreduce"])
@pytest.mark.parametrize("transform", [False, True],
                         ids=["plain", "aggregate"])
@pytest.mark.parametrize("wave", [True, False], ids=["wave", "per_event"])
@pytest.mark.parametrize("cap", [0, 6])
def test_injector_runs_are_equal(cap, wave, transform, family):
    ref, port = _both(_inject, cap=cap, wave=wave, transform=transform,
                      family=family)
    assert port == ref
    if cap:
        assert port["counts"][2] <= cap


# ------------------------------------------------------------- registry
def _registry_run(side):
    m, w, obs = CORE[side], W[side], OBS[side]
    rm = m.ResourceManager()
    rm.add_nodes(32, slots=1)
    s = m.Scheduler(rm, profile=fast_profile(m),
                    config=m.SchedulerConfig(heartbeat_interval=1.0))
    reg = obs.Registry()
    tap = w.MetricsTap(registry=reg)
    inj = w.StreamingInjector(
        s, w.synthetic_stream(seed=3, n_jobs=200, rate=16.0), tap=tap)
    plane = m.FaultPlane(s, _scaled(w.FAULT_PROFILES["kitchen_sink"], 0.005),
                         seed=3)
    reg.bind_scheduler(s).bind_resources(rm).bind_fault_plane(plane)
    reg.counter("extra").inc(3)
    reg.gauge("set").set(1.5)
    reg.histogram("h", size=8).add(2.0)
    inj.run()
    return {"names": reg.names(), "snapshot": reg.snapshot()}


def test_registry_snapshots_are_equal():
    ref, port = _both(_registry_run)
    assert port == ref
    assert port["snapshot"]["sched.completed"] > 0
    # the port's obs now exports all of the reference's (the recorder,
    # profiler and dashboard arrived beside the registry)
    assert port_obs.__all__ == ref_obs.__all__


def test_registry_refuses_a_type_change_as_the_reference_does():
    for obs in (ref_obs, port_obs):
        reg = obs.Registry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.histogram("x")
        with pytest.raises(TypeError):
            reg.gauge("g", lambda: 1).set(2)


# ---------------------------------------------------- reservoir, series
@pytest.mark.parametrize("size", [16, 512])
def test_reservoir_and_series_are_equal(size):
    rng = random.Random(11)
    xs = [rng.lognormvariate(0.0, 2.0) for _ in range(20_000)]
    out = []
    for w in (ref_w, port_w):
        res = w.Reservoir(size, seed=5)
        ts = w.TimeSeries(max_points=size)
        for i, x in enumerate(xs):
            res.add(x)
            ts.add(float(i), x)
        out.append(([res.percentile(q) for q in range(0, 101, 5)],
                    res.seen, ts.points, ts.stride))
    assert out[1] == out[0]

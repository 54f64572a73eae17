"""The port's observability plane (``repro_torch.obs``: flight recorder,
self-profiler, dashboard) against the reference's, with tolerance 0.

Each test runs one scenario on both packages: the reference's
``tests/test_obs.py`` helpers as they are, and their port copy loaded by
``torch_ref_suite`` (the same code, bound to ``repro_torch``). Both
packages' job-id counters restart at 1 before each run, so event streams,
Chrome-trace files, profiler call counts, dashboard frames and HTML reports
compare as they are written, ids included."""
import enum
import io
import itertools
import json
import random

import pytest

pytest.importorskip("torch")

import repro.core.job as ref_job  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
import repro_torch.core.job as port_job  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
import test_obs as REF  # noqa: E402
from repro.obs.dashboard import sparkline as ref_sparkline  # noqa: E402
from repro_torch.obs.dashboard import sparkline  # noqa: E402
from torch_ref_suite import load  # noqa: E402

PORT = load("test_obs")
SCENARIOS = sorted(REF.SCENARIOS)
CHAOS = sorted(REF.CHAOS_SCENARIOS)


@pytest.fixture(autouse=True)
def fresh_job_ids(monkeypatch):
    """Job ids from 1 in both packages, run after run."""
    def restart():
        monkeypatch.setattr(ref_job, "_job_ids", itertools.count(1))
        monkeypatch.setattr(port_job, "_job_ids", itertools.count(1))
    restart()
    return restart


def _plain(x):
    """Enums by value (each package has its own enum classes)."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _with_recorder(mod, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the recorder it makes kept: (its
    result, the recorder)."""
    made = []

    class Kept(mod.FlightRecorder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    base, mod.FlightRecorder = mod.FlightRecorder, Kept
    try:
        out = fn(*args, **kwargs)
    finally:
        mod.FlightRecorder = base
    assert len(made) == 1
    return out, made[0]


def _both(fresh, tmp_path, run):
    """``run(mod)`` (a test_obs helper's call, with the recorder it makes)
    on each package: results with enums as values, and the text of each
    recorder's Chrome-trace file, its recorded and dropped counts."""
    outs = []
    for side, mod in (("reference", REF), ("port", PORT)):
        fresh()
        out, rec = run(mod)
        path = tmp_path / f"{side}.json"
        written = rec.export_chrome(str(path))
        assert written == len(rec.events)
        outs.append((_plain(out), path.read_text(), rec.recorded,
                     rec.dropped))
    return outs


@pytest.mark.parametrize("wave", [False, True])
@pytest.mark.parametrize("name", SCENARIOS)
def test_recorder_stream_and_chrome_export_equal_the_references(
        name, wave, fresh_job_ids, tmp_path):
    ref, port = _both(fresh_job_ids, tmp_path, lambda mod: _with_recorder(
        mod, mod.record_scenario, wave, seed=1, **mod.SCENARIOS[name]))
    assert port[0]["events"] == ref[0]["events"]
    assert port[0]["counts"] == ref[0]["counts"]
    assert port[0]["engine"] == ref[0]["engine"]
    assert port[1] == ref[1]                 # the Chrome-trace JSON text
    assert port[2:] == ref[2:]
    assert json.loads(port[1])["traceEvents"]


def _chaos(mod, name, wave, fseed):
    kw = dict(mod.CHAOS_SCENARIOS[name])
    profile = kw.pop("profile")
    return _with_recorder(mod, mod.record_chaos, wave, profile, fseed, **kw)


@pytest.mark.parametrize("wave", [False, True])
@pytest.mark.parametrize("name", CHAOS)
def test_recorder_under_faults_equals_the_references(name, wave,
                                                     fresh_job_ids, tmp_path):
    ref, port = _both(fresh_job_ids, tmp_path,
                      lambda mod: _chaos(mod, name, wave, 2))
    assert port[0] == ref[0]                 # events, counts, tap, plane
    assert port[1] == ref[1]
    assert port[2:] == ref[2:]
    assert ref[0]["counts"].get("fault", 0) > 0


# -------------------------------------------------------------- profiler
def _profiled(mod, obs, executor, *, wave, arena=False, payloads=False,
              stride=1):
    rm = mod.ResourceManager()
    rm.add_nodes(4, slots=1)
    cfg = mod.SchedulerConfig(wave_batching=wave, arena=arena,
                              heartbeat_interval=0.5)
    s = mod.Scheduler(rm, profile=mod.FAST, config=cfg,
                      executor=executor.InlineExecutor() if payloads
                      else None)
    prof = obs.SelfProfiler(stride=stride).attach(s)
    rng = random.Random(7)
    for _ in range(12):
        n = rng.randint(1, 6)
        kw = ({"payloads": [(lambda: 0.0)] * n} if payloads else
              {"durations": [rng.random() for _ in range(n)]})
        s.submit(mod.Job.array(n, **kw))
    s.run()
    return {phase: (r["calls"], r["sampled"])
            for phase, r in prof.report().items()}


@pytest.mark.parametrize("mode", [
    dict(wave=False), dict(wave=True), dict(wave=True, arena=True),
    dict(wave=True, payloads=True), dict(wave=True, stride=3)],
    ids=["per_event", "wave", "arena", "executor", "stride3"])
def test_profiler_call_counts_equal_the_references(mode, fresh_job_ids):
    import repro.core.executor as ref_executor
    import repro_torch.core.executor as port_executor

    ref = _profiled(REF, ref_obs, ref_executor, **mode)
    fresh_job_ids()
    port = _profiled(PORT, port_obs, port_executor, **mode)
    assert port == ref
    assert port["admission"][0] == 12 and port["completion"][0] > 0


def test_profiler_refuses_a_scheduler_without_an_entry_point():
    """The port checks every entry point it wraps (the reference skips a
    missing one): the attach fails and wraps nothing."""
    s = PORT._small_engine()

    class Lacking:
        def __getattr__(self, name):
            if name == "_finish_arena":
                raise AttributeError(name)
            return getattr(s, name)

    prof = port_obs.SelfProfiler()
    with pytest.raises(AttributeError, match="_finish_arena"):
        prof.attach(Lacking())
    assert prof._sch is None and not prof._wrapped
    assert "submit" not in vars(s)
    prof.attach(s)
    assert sorted(prof._wrapped) == sorted(a for a, _ in
                                           port_obs.profile._PHASE_OF)


# ------------------------------------------------------------- dashboard
def _dashboard_run(mod, obs, tmp_path, side, *, faults):
    """A virtual run with a tap and a dashboard rendering at every hook
    (``fps=0``: the frames do not depend on the wall clock): every frame
    written, the final render and the HTML report."""
    rm = mod.ResourceManager(heartbeat_timeout=4.0)
    rm.add_nodes(24, slots=1)
    cfg = mod.SchedulerConfig(wave_batching=True, heartbeat_interval=1.0,
                              retry_backoff=0.25, quarantine_after=2)
    s = mod.Scheduler(rm, profile=mod.FAST, config=cfg)
    tap = mod.MetricsTap().attach(s)
    out = io.StringIO()
    dash = obs.Dashboard(tap.registry, tap=tap, out=out, fps=0).attach(s)
    if faults:
        plane = mod.FaultPlane(
            s, mod.CHAOS_SCENARIOS["kitchen_sink"]["profile"], seed=3)
        dash.registry.bind_fault_plane(plane)
    rng = random.Random(5)
    for _ in range(40):
        n = rng.randint(1, 6)
        j = mod.Job.array(n, durations=[rng.random() * 4 for _ in range(n)])
        j.max_restarts = 5
        s.submit(j)
    s.run()
    dash.finish()
    path = tmp_path / f"{side}.html"
    dash.export_html(str(path), title="parity run")
    return out.getvalue(), dash.render(), path.read_text(), dash.frames


@pytest.mark.parametrize("faults", [False, True], ids=["plain", "faults"])
def test_dashboard_frames_and_html_equal_the_references(faults, tmp_path,
                                                        fresh_job_ids):
    ref = _dashboard_run(REF, ref_obs, tmp_path, "reference", faults=faults)
    fresh_job_ids()
    port = _dashboard_run(PORT, port_obs, tmp_path, "port", faults=faults)
    assert port == ref
    frames, last, html, n = port
    assert n > 10 and frames.count("── scheduler @") == n
    assert "occupancy" in last and "latency mean" in last
    assert "<svg" in html and "tap.dispatches" in html
    assert ("faults:" in last) == faults


@pytest.mark.parametrize("values", [
    [], [1.0], [2.0, 2.0, 2.0], [0.0, 1.0, 2.0, 3.0],
    [random.Random(3).random() for _ in range(100)]])
@pytest.mark.parametrize("width", [4, 48])
def test_sparkline_equals_the_references(values, width):
    assert sparkline(values, width) == ref_sparkline(values, width)


def test_obs_exports_the_references_names():
    assert port_obs.__all__ == ref_obs.__all__

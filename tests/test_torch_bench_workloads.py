"""The port's benchmark drivers (``repro_torch.bench``: the Table-9 grid,
the Table-10 fit, Figs. 4-7, the workload and fault replays, the
throughput gate) against the reference's functions and committed
artifacts, with tolerance 0 on virtual-time results.

The reference's ``benchmarks.common.all_results`` writes
``experiments/bench_cache.json`` when a trial is missing, so it is never
called here: both sides' figure drivers read rows made by their own
``run_taskset``."""
import importlib
import json
import sys
from pathlib import Path

import pytest

from repro_torch.bench import (common, fault_replay, fig4_latency_scaling,
                               fig5_utilization, fig6_multilevel_latency,
                               fig7_multilevel_utilization, sched_throughput,
                               table9_tasksets, table10_model_fit,
                               workload_replay)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
EXPERIMENTS = ROOT / "experiments"
FIGURES = ("table10_model_fit", "fig4_latency_scaling", "fig5_utilization",
           "fig6_multilevel_latency", "fig7_multilevel_utilization")
PORT_FIGURES = {"table10_model_fit": table10_model_fit,
                "fig4_latency_scaling": fig4_latency_scaling,
                "fig5_utilization": fig5_utilization,
                "fig6_multilevel_latency": fig6_multilevel_latency,
                "fig7_multilevel_utilization": fig7_multilevel_utilization}


def _ref(name):
    """A module of the reference's ``benchmarks`` package (importing one
    writes nothing)."""
    return importlib.import_module(f"benchmarks.{name}")


def _artifact(name):
    return json.loads((EXPERIMENTS / name).read_text())


def _row(r):
    return {k: v for k, v in r.items() if k not in ("trial", "set")}


# ------------------------------------------------------------ the grid
def test_committed_rows_through_run_taskset():
    """The 15 rows of the committed bench_cache.json, through the port's
    all_results (which raises on a row that differs) and compared here."""
    committed = common.load_committed_cache()
    rows = common.all_results(trials=1)
    assert len(rows) == len(committed) == 15
    for r in rows:
        key = common._key(r["family"], r["n"], r["t"], False, 0)
        assert _row(r) == committed[key], key


@pytest.mark.parametrize("family,n,t", [("yarn", 48, 5.0),
                                        ("mesos", 8, 30.0)])
def test_multilevel_row_equals_the_reference(family, n, t):
    ref = _ref("common").run_taskset(family, n, t, multilevel=True)
    assert common.run_taskset(family, n, t, multilevel=True) == ref


def test_scaled_and_streamed_rows_equal_the_artifacts():
    """One run_scaled row (P = 102,400, n = 1) and one streamed grid row
    (yarn's long set: waves of P under 8 active jobs)."""
    scale = _artifact("table9_scale_P102400.json")
    assert common.run_taskset("slurm", 1, 1.0, processors=102400) == \
        scale["rows"][0]
    grid = common.load_grid_artifact(102400)
    want = next(r for r in grid["families"]["yarn"]["rows"]
                if r["set"] == "long")
    got = common.run_taskset("yarn", 4, 60.0, processors=102400,
                             wave_tasks=102400, max_active_jobs=8)
    assert common.without_wall(dict(got, set="long")) == \
        common.without_wall(want)
    assert got["stream"]["peak_active_jobs"] <= 8


@pytest.fixture(scope="module")
def grid_rows():
    """Each side's Table-9 rows from its own run_taskset, one trial:
    direct over the four schedulers, multilevel over Fig. 6's three."""
    out = {}
    for side, run in (("reference", _ref("common").run_taskset),
                      ("port", common.run_taskset)):
        rows = {}
        for ml, fams in ((False, common.SCHEDULERS),
                         (True, fig6_multilevel_latency.ML_SCHEDULERS)):
            for fam in fams:
                for name, t, n in common.TASK_SETS:
                    if fam == "yarn" and name == "rapid" and not ml:
                        continue
                    rows[(fam, name, ml)] = dict(run(fam, n, t, ml),
                                                 trial=0, set=name)
        out[side] = rows
    return out


def _fake_all_results(rows):
    def all_results(multilevel=False, trials=1,
                    schedulers=common.SCHEDULERS, **_):
        return [dict(r) for (fam, _, ml), r in rows.items()
                if ml == multilevel and fam in schedulers]
    return all_results


@pytest.mark.parametrize("figure", FIGURES)
def test_table10_and_figures_equal_the_reference(figure, grid_rows,
                                                 monkeypatch, capsys):
    """Each figure driver's return value and printed CSV, both sides fed
    their own rows (the reference's all_results would write its cache)."""
    got = {}
    for side, mod in (("reference", _ref(figure)),
                      ("port", PORT_FIGURES[figure])):
        monkeypatch.setattr(mod, "all_results",
                            _fake_all_results(grid_rows[side]))
        out = mod.run()
        if figure == "table10_model_fit":
            out = {k: (f.t_s, f.alpha_s, f.r2, f.n_values, f.dt_values)
                   for k, f in out.items()}
        elif figure == "fig4_latency_scaling":
            out = {k: (ns, dts, (f.t_s, f.alpha_s, f.r2))
                   for k, (ns, dts, f) in out.items()}
        got[side] = (out, capsys.readouterr().out)
    assert got["port"] == got["reference"]
    assert got["port"][1].count("\n") >= 5


@pytest.mark.parametrize("figure", ["fig4_latency_scaling",
                                    "fig5_utilization"])
def test_scaled_figure_views_equal_the_reference(figure, capsys):
    ref = _ref(figure).run_scaled(102400)
    ref_text = capsys.readouterr().out
    port = PORT_FIGURES[figure].run_scaled(102400)
    assert port == ref and capsys.readouterr().out == ref_text


# ------------------------------------------------------------- drivers
def test_replay_quick_smokes_pass(capsys):
    assert workload_replay.main(["--quick"]) == 0
    smoke = fault_replay.main(["--quick"])
    assert len(smoke["checks"]) == 3 and smoke["silent_detection"]["n"] > 0
    out = capsys.readouterr().out
    assert "workload replay smoke OK" in out and "chaos smoke" in out


def _listing():
    """Every file of experiments/ and of the repo's root, with mtimes."""
    return {str(p.relative_to(ROOT)): p.stat().st_mtime_ns
            for d in (EXPERIMENTS, ROOT) for p in d.iterdir() if p.is_file()}


def test_drivers_write_only_their_out(tmp_path, capsys):
    before = _listing()
    table9_tasksets.main(["--P", "256", "--n-values", "1", "2"])
    table9_tasksets.main(["--P", "256", "--n-values", "1", "2",
                          "--out", str(tmp_path / "scale.json")])
    table9_tasksets.main(["--P", "128", "--grid",
                          "--out", str(tmp_path / "grid.json")])
    assert workload_replay.main(["--family", "poisson", "--jobs", "200",
                                 "--P", "64"]) == 0
    assert workload_replay.main(["--swf", str(workload_replay.FIXTURE),
                                 "--P", "64",
                                 "--out", str(tmp_path / "swf.json")]) == 0
    fault_replay.main(["--sets", "long", "--mtbf", "4000"])
    fault_replay.main(["--sets", "long", "--mtbf", "4000",
                       "--out", str(tmp_path / "faults.json")])
    assert _listing() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "faults.json", "grid.json", "scale.json", "swf.json"]
    grid = json.loads((tmp_path / "grid.json").read_text())
    assert list(grid["families"]) == list(common.SCHEDULERS)
    faults = json.loads((tmp_path / "faults.json").read_text())
    assert faults["rows"][0]["baseline_check"] == "match"
    capsys.readouterr()


DASHBOARD_RUNS = {
    "workload_replay": ["--family", "poisson", "--jobs", "300", "--P", "64"],
    "fault_replay": ["--sets", "long", "--mtbf", "4000"],
}


def _run_driver(side, name, argv, tmp_path, monkeypatch, capsys):
    """One driver run with the dashboard's final frames kept: (the frames
    ``finish`` rendered, every frame written to stderr, the HTML report or
    None). The reference's fault_replay writes its artifact, so it gets an
    --out; its workload_replay reads sys.argv."""
    import repro.obs.dashboard as ref_dashboard
    import repro_torch.obs.dashboard as port_dashboard

    dash_mod = ref_dashboard if side == "reference" else port_dashboard
    finals = []
    finish = dash_mod.Dashboard.finish

    def kept(self):
        finish(self)
        finals.append(self.render())

    monkeypatch.setattr(dash_mod.Dashboard, "finish", kept)
    html = tmp_path / f"{side}.html"
    argv = [a if a != "HTML" else str(html) for a in argv]
    if name == "fault_replay":
        argv += ["--out", str(tmp_path / f"{side}.json")]
    capsys.readouterr()
    if side == "port":
        (workload_replay if name == "workload_replay"
         else fault_replay).main(argv)
    elif name == "workload_replay":
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
        _ref(name).main()
    else:
        _ref(name).main(argv)
    err = capsys.readouterr().err
    return finals, err, html.read_text() if html.exists() else None


@pytest.mark.parametrize("flag", ["--dashboard", "--html"])
@pytest.mark.parametrize("name", ["workload_replay", "fault_replay"])
def test_dashboard_flags_match_the_reference(name, flag, tmp_path,
                                             monkeypatch, capsys):
    """Each flag as the reference driver takes it: the frames its
    dashboard ends each run with and its HTML report equal the reference
    driver's (the frames between are paced by the wall clock). The
    reference's fault_replay has no --html, and the port's refuses it too."""
    argv = DASHBOARD_RUNS[name] + ([flag] if flag == "--dashboard"
                                   else [flag, "HTML"])
    if name == "fault_replay" and flag == "--html":
        for side in ("reference", "port"):
            with pytest.raises(SystemExit) as e:
                _run_driver(side, name, argv, tmp_path, monkeypatch, capsys)
            assert e.value.code == 2
            assert "unrecognized arguments: --html" in \
                capsys.readouterr().err
        return
    ref = _run_driver("reference", name, argv, tmp_path, monkeypatch, capsys)
    port = _run_driver("port", name, argv, tmp_path, monkeypatch, capsys)
    finals, err, html = port
    assert finals == ref[0] and html == ref[2]
    # fault_replay: a dashboard on each of the 4 cells of the set
    assert len(finals) == (4 if name == "fault_replay" else 1)
    assert err.count("── scheduler @") >= len(finals)
    assert err.rstrip().endswith(finals[-1])
    assert "dispatched" in finals[-1] and "latency mean" in finals[-1]
    if flag == "--html":
        assert "<svg" in html and "tap.dispatches" in html
    else:
        assert html is None


# ------------------------------------------------------------- the gate
ONE_REGIME = (("jobs_500x4", 500, 4, ((64, 1),), None, False),)


def test_check_baseline_defaults_to_the_committed_anchor(monkeypatch,
                                                         capsys):
    seen = []
    monkeypatch.setattr(sched_throughput, "QUICK_FIFO", ONE_REGIME)
    monkeypatch.setattr(sched_throughput, "check_baseline",
                        lambda rows, path: seen.append(path))
    sched_throughput.main(["--quick", "--suite", "fifo", "--trials", "1",
                           "--check-baseline"])
    sched_throughput.main(["--quick", "--suite", "fifo", "--trials", "1"])
    assert seen == [ROOT / "BENCH_sched_throughput.json"]
    assert sched_throughput.ANCHOR == seen[0] and seen[0].exists()
    capsys.readouterr()


def test_trials_are_taken_in_turns_across_the_regimes(monkeypatch,
                                                     capsys):
    """Trial k of every regime runs before trial k + 1 of any; each row is
    its regime's fastest trial."""
    walls = iter([0.3, 0.2, 0.1, 0.4, 0.6, 0.5])
    order = []

    def fake(name, *regime, **kw):
        order.append(name)
        return {"name": name, "jobs": 1, "tasks_per_job": 4, "nodes": 1,
                "slots_total": 1, "policy": "fifo", "total_tasks": 4,
                "wall_s": (w := next(walls)), "tasks_per_s": 4 / w}

    three = tuple((f"r{i}",) + ONE_REGIME[0][1:] for i in range(3))
    monkeypatch.setattr(sched_throughput, "QUICK_FIFO", three)
    monkeypatch.setattr(sched_throughput, "run_regime", fake)
    rows = sched_throughput.main(["--quick", "--suite", "fifo", "--trials",
                                  "2"])["regimes"]
    assert order == ["r0", "r1", "r2"] * 2
    assert [(r["name"], r["wall_s"]) for r in rows] == \
        [("r0", 0.3), ("r1", 0.2), ("r2", 0.1)]
    capsys.readouterr()


def test_check_baseline_fails_on_a_doctored_anchor(tmp_path, monkeypatch,
                                                   capsys):
    """Every regime of the committed anchor x1,000: the gate raises."""
    anchor = json.loads(sched_throughput.ANCHOR.read_text())
    for r in anchor["regimes"]:
        r["tasks_per_s"] *= 1000
    doctored = tmp_path / "anchor.json"
    doctored.write_text(json.dumps(anchor))
    before = sched_throughput.ANCHOR.stat().st_mtime_ns
    monkeypatch.setattr(sched_throughput, "QUICK_FIFO", ONE_REGIME)
    with pytest.raises(SystemExit) as e:
        sched_throughput.main(["--quick", "--suite", "fifo", "--trials",
                               "1", "--check-baseline", str(doctored)])
    assert "jobs_500x4" in str(e.value)
    assert sched_throughput.ANCHOR.stat().st_mtime_ns == before
    assert "REGRESSION" in capsys.readouterr().out

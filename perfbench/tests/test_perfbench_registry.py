"""The harness finds each cell's files by name, refuses unknown names, and
BENCHMARK.json keeps to the benchmark's contract."""
import json
import re

import pytest

from perfbench import registry

BENCH = registry.benchmark()
ROOT = registry.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and \
            (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            allowed = {"name", "unit", "better", "source"} | (
                {"bound"} if section == "end_to_end" else
                {"layer", "moves"}) | {"workloads"}
            assert set(m) <= allowed and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    names += CELLS
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in BENCH["configs"])) == \
        len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  registry.metrics_of_e2e(cell, BENCH)}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    w = registry.workload(cell, BENCH)
    cfg = registry.config(w["config"], BENCH)
    mix = registry.mix(w["traffic"])
    assert registry.driver(mix["driver"]).run
    assert registry.reference(cfg["reference"]).sizes(cfg["model"])
    limits = registry.limits(cell)
    assert limits and all("limit" in v for v in limits.values())
    e2e = registry.metrics_of(cell, BENCH, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = registry.metrics_of(cell, BENCH, "per_layer")
    assert layer
    for m in e2e + layer:
        assert callable(registry.metric(m["name"]).read)


def test_every_config_is_used_and_fits_one_chip_rule():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("kind,call", [
    ("workload", lambda: registry.workload("no-such-cell", BENCH)),
    ("config", lambda: registry.config("no_such_config", BENCH)),
    ("traffic", lambda: registry.mix("no_such_mix")),
    ("driver", lambda: registry.driver("no_such_driver")),
    ("reference", lambda: registry.reference("no_such_reference")),
    ("metric", lambda: registry.metric("no_such_metric")),
    ("limits", lambda: registry.limits("no-such-cell")),
    ("path", lambda: registry.mix("../BENCHMARK")),
])
def test_unknown_names_are_refused(kind, call):
    with pytest.raises(LookupError):
        call()


def test_a_check_fits_the_time_allowed():
    """2 + 14 cells runs of run_seconds + 60 s, 2 x 90 s a cell to compile,
    1200 s spare, with the full 24 cells, within 43,200 s."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel

"""Finds a cell's files by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``mixes/<traffic>.json``;
- a driver: ``drivers/<driver>.py``, named by the mix;
- a reference: ``reference/<reference>.py``, named by the configuration;
- a metric, end-to-end or per-layer: ``metrics/<name>.py``;
- a cell's limits for ``correct``: ``limits/<workload>.json``.

An unknown name raises ``LookupError``.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise LookupError(f"{kind} name {name!r} is not a valid name")
    return name


def benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def workload(name: str, bench: dict) -> dict:
    _check_name("workload", name)
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise LookupError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench: dict) -> dict:
    """The configuration's file, parsed, with its BENCHMARK.json entry
    under ``"entry"``."""
    _check_name("config", name)
    for c in bench["configs"]:
        if c["name"] == name:
            path = ROOT / c["file"]
            if not path.is_file():
                raise LookupError(f"config {name!r}: no file {c['file']}")
            return dict(json.loads(path.read_text()), entry=c)
    raise LookupError(f"no config {name!r} in BENCHMARK.json")


def _file(kind: str, sub: str, name: str, suffix: str) -> Path:
    path = HERE / sub / f"{_check_name(kind, name)}{suffix}"
    if not path.is_file():
        raise LookupError(f"no {kind} {name!r} (looked for "
                          f"{path.relative_to(ROOT)})")
    return path


def mix(name: str) -> dict:
    return json.loads(_file("traffic", "mixes", name, ".json").read_text())


def limits(name: str) -> dict:
    return json.loads(_file("limits", "limits", name, ".json").read_text())


_MODULES: Dict[Path, ModuleType] = {}


def _module(kind: str, sub: str, name: str) -> ModuleType:
    path = _file(kind, sub, name, ".py")
    if path not in _MODULES:
        modname = "perfbench_" + sub + "_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def driver(name: str) -> ModuleType:
    return _module("driver", "drivers", name)


def reference(name: str) -> ModuleType:
    return _module("reference", "reference", name)


def metric(name: str) -> ModuleType:
    return _module("metric", "metrics", name)


def metrics_of(cell: str, bench: dict, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, and those without a
    ``workloads`` key whose moved metric (per-layer) the cell reports."""
    e2e = {m["name"] for m in metrics_of_e2e(cell, bench)}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def metrics_of_e2e(cell: str, bench: dict) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]

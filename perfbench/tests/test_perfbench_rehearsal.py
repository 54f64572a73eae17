"""The harness end to end on the CPU, on each cell at the smoke
configurations' sizes: the reference agrees with the port there, and the
result has exactly the contract's keys. The command itself refuses to
run without a card, and in a directory that holds only BENCHMARK.json
and the benchmark's files."""
import json
import shutil
import subprocess
import sys
import time

import pytest

from conftest import SERVE, TRAIN, overrides
from perfbench import registry, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
BENCH = registry.benchmark()


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_end_to_end_on_the_cpu(cell, trace):
    result, notes = run.run_cell(cell, 2 ** 31 + 11, 1.0, bool(trace),
                                 device="cpu", t_start=time.perf_counter(),
                                 overrides=overrides(cell))
    line = json.loads(json.dumps(result))
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True, (line["checks"], notes)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in registry.metrics_of(cell, BENCH, section)}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        assert set(line["metrics"]) == names
    else:
        # no device on the CPU: the readers of the trace find nothing
        assert not any(n.startswith(("device_idle", "k1_", "optimizer"))
                       for n in line["metrics"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_command_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(registry.HERE / "run.py"), "--workload", SERVE,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=registry.ROOT, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_command_refuses_without_the_program(tmp_path):
    shutil.copy(registry.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(registry.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", SERVE, "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""

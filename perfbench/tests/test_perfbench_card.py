"""Each cell once on the card, briefly, through the command itself
(``python -m pytest -q -m gpu perfbench/tests`` on a machine with an
H100; skips without CUDA)."""
import json
import subprocess
import sys

import pytest

from perfbench import registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=registry.ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"

"""The loader of the reference's tests (``tests/torch_ref_suite.py``):
what it rewrites, and that it refuses what it does not."""
import pytest

pytest.importorskip("torch")

import torch_ref_suite  # noqa: E402


def _translate(tmp_path, source):
    path = tmp_path / "test_fake.py"
    path.write_text(source)
    return torch_ref_suite.translate("test_fake", path)


@pytest.mark.parametrize("source", [
    "from test_scheduler import FAST\n",
    "import test_hotpath\n",
    "def test_x():\n    from test_obs import record_scenario\n",
    "import sched_throughput\n",
    "from rt_replay import chaos_soak\n",
    "from benchmarks.common import run_taskset\n",
    "import benchmarks\n",
    "from repro.launch import train\n",
    "import jax.numpy as jnp\n",
], ids=["test_module", "test_module_import", "test_module_in_body",
        "benchmark", "benchmark_from", "benchmarks_package",
        "benchmarks_bare", "reference", "jax"])
def test_refuses_what_it_does_not_rewrite(tmp_path, source):
    with pytest.raises(ImportError, match="after the rewrite"):
        _translate(tmp_path, source)


def test_rewrites_siblings_benchmarks_and_packages(tmp_path):
    tree, _ = _translate(tmp_path, (
        "from test_wavepath import SCENARIOS\n"
        "from test_faultplane import CHAOS_SCENARIOS\n"
        "from repro.rt import AsyncRuntime\n"
        "from repro.obs import FlightRecorder\n"
        "def test_x():\n    from common import run_taskset\n"))
    modules = [node.module for node, _ in torch_ref_suite._imports(tree)]
    assert modules == ["torch_ref.test_wavepath", "torch_ref.test_faultplane",
                       "repro_torch.rt", "repro_torch.obs",
                       "repro_torch.bench.common"]


def test_loaded_suite_runs_on_the_port_copies_of_its_siblings():
    mod = torch_ref_suite.load("test_obs")
    sibling = mod.engine_signature.__globals__
    assert sibling["__name__"] == "torch_ref.test_wavepath"
    assert sibling["Scheduler"].__module__ == "repro_torch.core.scheduler"
    assert mod.CHAOS_SCENARIOS["churn"]["profile"].__class__.__module__ \
        == "repro_torch.core.faults"
    assert mod.FlightRecorder.__module__ == "repro_torch.obs.trace"

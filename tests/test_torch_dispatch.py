"""The port's real-dispatch path against the reference's: the torch and
JAX dispatch executors, each driven by the reference's Scheduler over the
same job array (one payload raises); the copies of the latency model; and
the dispatch benchmark's rows on the CPU."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import latency_model as ref_lm  # noqa: E402
from repro.core.executor import JaxDispatchExecutor  # noqa: E402
from repro.core.job import Job, JobState, TaskState  # noqa: E402
from repro.core.resources import ResourceManager  # noqa: E402
from repro.core.scheduler import Scheduler  # noqa: E402
from repro_torch.bench import dispatch_latency  # noqa: E402
from repro_torch.core import latency_model as port_lm  # noqa: E402
from repro_torch.core.executor import (Executor, InlineExecutor,  # noqa: E402
                                       TorchDispatchExecutor, _block)
from repro_torch.core.job import Task  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_TASKS, RAISES = 12, 5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which are no
    faster on more threads, and the other test workers need the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _payloads(side: str):
    """Seeded matrix chains on either side; task RAISES raises."""
    def make(i):
        a = np.random.default_rng(i).standard_normal((16, 16)).astype(
            np.float32) / 4
        b = np.random.default_rng(100 + i).standard_normal((16,)).astype(
            np.float32)

        def work():
            if i == RAISES:
                raise ValueError(f"payload {i} fails")
            if side == "torch":
                x, v = torch.from_numpy(a), torch.from_numpy(b)
                return {"y": torch.tanh(x @ x) @ v, "n": (x.mean(), i)}
            x, v = jnp.asarray(a), jnp.asarray(b)
            return {"y": jnp.tanh(x @ x) @ v, "n": (x.mean(), i)}
        return work
    return [make(i) for i in range(N_TASKS)]


def _schedule(executor, side, slots):
    rm = ResourceManager()
    rm.add_nodes(slots, slots=1)
    sched = Scheduler(rm, executor=executor)
    job = Job.array(N_TASKS, payloads=_payloads(side))
    sched.submit(job)
    sched.run()
    return sched, job


@pytest.mark.parametrize("slots", [1, 4])
def test_executors_agree_under_the_reference_scheduler(slots):
    torch_ex, jax_ex = TorchDispatchExecutor(), JaxDispatchExecutor()
    s_t, job_t = _schedule(torch_ex, "torch", slots)
    s_j, job_j = _schedule(jax_ex, "jax", slots)
    assert s_t.completed == s_j.completed == N_TASKS
    assert s_t.dispatched == s_j.dispatched
    assert job_t.state is job_j.state is JobState.FAILED
    assert [t.state for t in job_t.tasks] == [t.state for t in job_j.tasks]
    assert job_t.tasks[RAISES].state is TaskState.FAILED
    assert {k[1] for k in torch_ex.errors} == {k[1] for k in jax_ex.errors} \
        == {RAISES}
    assert all(isinstance(e, ValueError) for e in torch_ex.errors.values())
    by_index = {k[1]: v for k, v in jax_ex.results.items()}
    assert {k[1] for k in torch_ex.results} == set(by_index)
    for (_, i), out in torch_ex.results.items():
        ref = by_index[i]
        np.testing.assert_allclose(out["y"].numpy(), np.asarray(ref["y"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["n"][0].item(),
                                   float(ref["n"][0]), rtol=1e-6, atol=1e-6)
        assert out["n"][1] == ref["n"][1] == i


def test_executor_records_errors_and_results():
    for ex in (InlineExecutor(), TorchDispatchExecutor()):
        assert isinstance(ex, Executor)
        outcomes = []
        ex.run(Task(1, 0, payload=lambda: torch.ones(2)), outcomes.append)
        ex.run(Task(1, 1, payload=lambda: 1 / 0), outcomes.append)
        ex.run(Task(1, 2), outcomes.append)    # no payload: completes ok
        assert outcomes == [True, False, True]
        assert isinstance(ex.errors[(1, 1)], ZeroDivisionError)
        assert set(ex.results) == {(1, 0)}
    with pytest.raises(NotImplementedError):
        Executor().run(Task(1, 0), lambda ok: None)


def test_block_does_not_wait_on_cpu_tensors(monkeypatch):
    """CPU tensors are done when the payload returns: no stream is
    synchronised."""
    calls = []

    class FakeStream:
        def __init__(self, dev):
            self.dev = dev

        def synchronize(self):
            calls.append(self.dev)

    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    out = {"a": torch.ones(2), "b": [torch.zeros(1), (3, "x")]}
    assert _block(out) is out
    assert calls == []


def test_latency_model_copies_equal_the_reference():
    t = np.array([1e-6, 3e-5, 1e-3, 0.5])
    np.testing.assert_array_equal(port_lm.utilization_approx(t, 2e-5),
                                  ref_lm.utilization_approx(t, 2e-5))
    assert port_lm.utilization_approx(1e-3, 1e-4) == \
        ref_lm.utilization_approx(1e-3, 1e-4)
    rng = np.random.default_rng(3)
    n = np.array([1, 4, 16, 64, 256, 1024])
    dt = 2e-5 * n ** 1.07 * np.exp(rng.normal(0, 0.05, n.size))
    got, want = port_lm.fit_power_law(n, dt), ref_lm.fit_power_law(n, dt)
    assert (got.t_s, got.alpha_s, got.r2, got.n_values, got.dt_values) == (
        want.t_s, want.alpha_s, want.r2, want.n_values, want.dt_values)
    assert str(got) == str(want)
    flat = port_lm.fit_power_law([1, 2, 4], [0.0, 0.0, 0.0])
    assert flat == port_lm.ModelFit(**vars(ref_lm.fit_power_law(
        [1, 2, 4], [0.0, 0.0, 0.0])))


def _reference_dispatch_module():
    spec = importlib.util.spec_from_file_location(
        "ref_dispatch_latency", ROOT / "benchmarks" / "dispatch_latency.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dispatch_latency_rows_on_the_cpu(capsys, monkeypatch):
    """The port's rows carry the reference's keys (and the kernels a task
    launches, None on the CPU), for the same flops scales. The reference's
    rows come from its own ``utilization_curve`` over a no-op task: its
    keys are compared, not its times."""
    ref = _reference_dispatch_module()
    monkeypatch.setattr(ref, "measure_dispatch_ts", lambda: 1e-5)
    monkeypatch.setattr(ref, "_work_fn",
                        lambda scale: (lambda x: x, jnp.zeros(())))
    _, ref_rows = ref.utilization_curve()
    t_s, rows = dispatch_latency.run(device="cpu")
    assert 0 < t_s < 1
    assert [r["flops_scale"] for r in rows] == [r["flops_scale"]
                                                for r in ref_rows]
    for r, rr in zip(rows, ref_rows):
        assert set(rr) <= set(r)
        assert set(r) - set(rr) == {"launches_per_task",
                                    "utilization_rounds"}
        assert len(r["utilization_rounds"]) == 4
        assert r["launches_per_task"] is None
        assert r["t_task_ms"] > 0 and r["t_aggregated_ms"] > 0
        assert 0 < r["model_U"] < 1
    out = capsys.readouterr().out
    assert out.splitlines()[1].startswith("torch_dispatch_ts_us,")


def test_dispatch_tasks_and_fit_on_the_cpu():
    dev = torch.device("cpu")
    step, x = dispatch_latency._work_fn(0, dev)
    assert torch.equal(step(x), -x)
    step4, x = dispatch_latency._work_fn(4, dev)
    y = x
    for _ in range(4):
        y = torch.tanh(y @ y)
    assert torch.equal(step4(x), y)
    fit = dispatch_latency.fit_dispatch_latency(dev, n_values=(5, 20, 80))
    assert fit.t_s > 0 and fit.n_values == (5.0, 20.0, 80.0)
    ex = dispatch_latency.executor_latency(dev, n_tasks=20)
    assert ex["ok"] == 20 and ex["errors"] == 0 and ex["mean_s"] > 0


def test_dispatch_latency_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        dispatch_latency.run(device="cuda", quiet=True)

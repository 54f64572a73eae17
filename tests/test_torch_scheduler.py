"""The port's scheduler core against the reference's, on the CPU: the same
job stream through both packages' Scheduler must give equal JobStats and
equal tasks (node, start, end, attempts, state), with 0 tolerance — on the
wave path and the per-event path, with mixed widths, gangs, a zero-slot
license and a DAG dependency, under each of the four policies; the
quickstart's and the table9_rapid_slurm numbers; ThreadExecutor; the
port's Scheduler + TorchDispatchExecutor against the reference's
Scheduler + JaxDispatchExecutor; and the latency model's functions."""
import importlib.util
import random
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import latency_model as ref_lm  # noqa: E402
from repro_torch.bench import sched_throughput  # noqa: E402
from repro_torch.core import latency_model as port_lm  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from torch_sched_parity import (PORT, REF, both, fast_profile,  # noqa: E402
                                signature)

ROOT = Path(__file__).resolve().parents[1]


def _reference(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the payloads are tiny, and the other test
    workers need the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ scenarios
def fifo_arrays(m, *, wave, arena, seed=3, nodes=16, n_jobs=60):
    """Unit-slot job arrays of seeded widths and durations."""
    rng = np.random.default_rng(seed)
    rm = m.ResourceManager()
    rm.add_nodes(nodes, slots=1)
    s = m.Scheduler(rm, profile=fast_profile(m),
                    config=m.SchedulerConfig(wave_batching=wave,
                                             arena=arena))
    jobs = []
    for _ in range(n_jobs):
        n = int(rng.integers(1, 9))
        durs = [float(d) for d in rng.random(n) * 2.0]
        j = m.Job.array(n, durations=durs)
        jobs.append(j)
        s.submit(j)
    s.run()
    return signature(s, jobs)


@pytest.mark.parametrize("wave,arena", [(True, True), (True, False),
                                        (False, False)])
def test_fifo_arrays_match(wave, arena):
    ref, port = both(fifo_arrays, wave=wave, arena=arena)
    assert port == ref
    assert len(port["stats"]) == 60


def test_one_large_array_on_the_wave_path_matches():
    """One array far wider than the cluster: waves of numpy prefix sums
    (longer than the scheduler's numpy threshold)."""
    def run(m):
        rm = m.ResourceManager()
        rm.add_nodes(128, slots=1)
        s = m.Scheduler(rm, profile=m.FAMILIES["slurm"])
        j = m.Job.array(128 * 20, duration=1.0)
        s.submit(j)
        s.run()
        return signature(s, [j])
    ref, port = both(run)
    assert port == ref


def mixed(m, *, wave, policy=None, seed=11, licensed=True):
    """Mixed widths (multi-slot requests on multi-slot nodes), a gang job,
    a zero-slot license job (unless not ``licensed``), a DAG dependency and
    priorities."""
    rng = random.Random(seed)
    rm = m.ResourceManager()
    rm.add_nodes(6, slots=4)
    rm.add_nodes(4, slots=2)
    rm.add_license("lic", 2)
    pol = None if policy is None else m.make_policy(policy)
    s = m.Scheduler(rm, policy=pol, profile=fast_profile(m),
                    config=m.SchedulerConfig(wave_batching=wave))
    jobs = []
    for i in range(24):
        n = rng.randint(1, 5)
        req = m.ResourceRequest(slots=rng.choice((1, 2, 4)))
        j = m.Job.array(n, durations=[rng.random() * 3 for _ in range(n)],
                        request=req, priority=float(rng.randint(0, 2)))
        jobs.append(j)
    gang = m.Job.parallel_job(6, duration=1.5, name="gang",
                              request=m.ResourceRequest(slots=2))
    lic = m.Job.array(5, duration=0.7, request=m.ResourceRequest(
        slots=0, licenses=("lic",)), name="licensed")
    first = m.Job.array(3, duration=0.5, name="first")
    then = m.Job.array(2, duration=0.25, name="then")
    then.depends_on = (first.job_id,)
    jobs[8:8] = [gang] + [lic] * licensed + [first, then]
    for j in jobs:
        s.submit(j)
    s.run()
    return signature(s, jobs)


@pytest.mark.parametrize("wave", [True, False])
def test_mixed_widths_gang_license_and_dag_match(wave):
    ref, port = both(mixed, wave=wave)
    assert port == ref
    assert all(state == "completed" for state, *_ in port["jobs"])


@pytest.mark.parametrize("policy", ["fifo", "backfill", "binpack",
                                    "locality"])
def test_each_policy_matches(policy):
    # the reference's locality policy over-assigns licensed tasks (below)
    ref, port = both(mixed, wave=True, policy=policy,
                     licensed=policy != "locality")
    assert port == ref
    assert all(state == "completed" for state, *_ in port["jobs"])


def test_locality_counts_licenses_within_a_cycle():
    """Two licenses, five zero-slot licensed tasks: the reference's
    locality policy assigns all five in one cycle and its allocate asserts;
    the port's places two a cycle, as backfill and bin-packing do."""
    with pytest.raises(AssertionError):
        mixed(REF, wave=True, policy="locality")
    port = mixed(PORT, wave=True, policy="locality")
    assert all(state == "completed" for state, *_ in port["jobs"])
    backfill = mixed(PORT, wave=True, policy="backfill")
    licensed = port["tasks"][9]
    assert len(licensed) == 5 and licensed == backfill["tasks"][9]


def test_preemption_speculation_and_node_failure_match():
    """Preemption by priority, straggler clones and a node marked down
    mid-run, on the per-event path."""
    def run(m):
        rm = m.ResourceManager()
        rm.add_nodes(8, slots=1)
        s = m.Scheduler(rm, profile=fast_profile(m), config=m.SchedulerConfig(
            preemption=True, speculative=True))
        lo = m.Job.array(16, durations=[1.0 + (i % 5) * 0.1
                                        for i in range(16)], priority=0.0)
        lo.max_restarts = 3
        slow = m.Job.array(8, durations=[0.5] * 7 + [9.0], priority=0.0)
        hi = m.Job.array(4, duration=0.5, priority=5.0)
        for j in (lo, slow):
            s.submit(j)
        s.run(until=0.3)
        s.submit(hi)
        s.run(until=0.8)
        rm.mark_down(2)
        s.run()
        return signature(s, [lo, slow, hi]), slow.n_clones
    ref, port = both(run)
    assert port == ref
    sig, clones = port
    assert clones == 1 and sig["counters"][2] >= 1   # a clone, a requeue


# ----------------------------------------------------------- golden runs
def test_quickstart_matches_the_reference_example():
    ref = _reference("examples/quickstart.py", "ref_quickstart")
    for multilevel in (False, True):
        assert quickstart.run(multilevel) == ref.run(multilevel)
    t_raw, u_raw = quickstart.run(False)
    t_ml, u_ml = quickstart.run(True)
    assert (f"{t_raw:.1f}", f"{u_raw:.1%}") == ("3604.2", "6.7%")
    assert (f"{t_ml:.1f}", f"{u_ml:.1%}") == ("253.4", "94.7%")
    # the reference example's fit, computed with the reference's classes
    ns, dts = [], []
    for n, t in quickstart.FIT_GRID:
        rm = REF.ResourceManager()
        rm.add_nodes(ref.P, slots=1)
        s = REF.Scheduler(rm, profile=REF.FAMILIES["slurm"])
        job = REF.Job.array(n * ref.P, duration=t)
        s.submit(job)
        s.run()
        st = s.stats[job.job_id]
        ns.append(n)
        dts.append((st.last_end - st.submit_time) - n * t)
    port_ns, port_dts, fit = quickstart.model_fit()
    assert (port_ns, port_dts) == (ns, dts)
    want = ref_lm.fit_power_law(ns, dts)
    assert (fit.t_s, fit.alpha_s, fit.r2) == (want.t_s, want.alpha_s,
                                              want.r2)


def test_table9_rapid_slurm_makespan_matches():
    ref = _reference("benchmarks/sched_throughput.py", "ref_sched_bench")
    regime = next(r for r in ref.FIFO_REGIMES
                  if r[0] == "table9_rapid_slurm")
    assert regime in sched_throughput.FIFO_REGIMES
    want = ref.run_regime(*regime)
    got = sched_throughput.run_regime(*regime)
    assert want["virtual_makespan_s"] == 3603.807
    assert round(got["virtual_makespan_s"], 3) == 3603.807
    assert got["total_tasks"] == want["total_tasks"] == 240 * 1408


def test_quick_regimes_match_the_reference_benchmark():
    ref = _reference("benchmarks/sched_throughput.py", "ref_sched_bench")
    assert sched_throughput.QUICK_FIFO == ref.QUICK_FIFO
    assert sched_throughput.QUICK_POLICY == ref.QUICK_POLICY
    assert sched_throughput.FIFO_REGIMES == ref.FIFO_REGIMES
    assert sched_throughput.POLICY_REGIMES == ref.POLICY_REGIMES
    for regime in (ref.QUICK_FIFO[4], ref.QUICK_POLICY[5]):
        want, got = ref.run_regime(*regime), sched_throughput.run_regime(
            *regime)
        assert round(got["virtual_makespan_s"], 3) == \
            want["virtual_makespan_s"]
        assert got["total_tasks"] == want["total_tasks"]


def test_sched_throughput_writes_only_where_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = sched_throughput.main(["--quick", "--suite", "fifo",
                                 "--trials", "1"])
    assert list(tmp_path.iterdir()) == []
    assert [r["name"] for r in res["regimes"]] == [
        r[0] for r in sched_throughput.QUICK_FIFO]
    out = tmp_path / "sub" / "r.json"
    sched_throughput.main(["--quick", "--suite", "fifo", "--trials", "1",
                           "--out", str(out)])
    assert out.exists()


# ------------------------------------------------------------ executors
def _thread_run(m, workers):
    """Pure-Python payloads on worker threads; task 3 raises."""
    def make(i):
        def work():
            if i == 3:
                raise KeyError(i)
            return sum(k * k for k in range(100 * i))
        return work
    rm = m.ResourceManager()
    rm.add_nodes(4, slots=1)
    ex = m.executor.ThreadExecutor(workers=workers)
    s = m.Scheduler(rm, profile=m.FAMILIES["inproc"], executor=ex)
    job = m.Job.array(10, payloads=[make(i) for i in range(10)])
    job.max_restarts = 1
    s.submit(job)
    s.run()
    ex.shutdown()
    return ({k[1]: v for k, v in ex.results.items()},
            {k[1]: type(e).__name__ for k, e in ex.errors.items()},
            [(t.state.value, t.attempts) for t in job.tasks],
            job.state.value, s.completed, ex.outstanding)


@pytest.mark.parametrize("workers", [1, 3])
def test_thread_executor_results_and_errors_match(workers):
    ref, port = both(_thread_run, workers)
    assert port == ref
    results, errors, tasks, state, completed, outstanding = port
    assert errors == {3: "KeyError"} and 3 not in results
    assert tasks[3] == ("failed", 2) and state == "failed"
    assert completed == 11 and outstanding == 0


def test_thread_executor_pump_and_drain():
    ex = PORT.executor.ThreadExecutor(workers=2)
    done = []
    for i in range(6):
        ex.run(PORT.Task(0, i, payload=lambda i=i: i * 2), done.append)
    ex.drain(timeout=10)
    assert done == [True] * 6 and ex.outstanding == 0
    assert {k[1]: v for k, v in ex.results.items()} == {
        i: i * 2 for i in range(6)}
    ex.shutdown()
    assert ex.pump() == 0


N_TASKS, RAISES = 12, 5


def _dispatch_payloads(side: str):
    """Seeded matrix chains; task RAISES raises."""
    def make(i):
        a = np.random.default_rng(i).standard_normal((16, 16)).astype(
            np.float32) / 4

        def work():
            if i == RAISES:
                raise ValueError(f"payload {i} fails")
            if side == "port":
                x = torch.from_numpy(a)
                return torch.tanh(x @ x)
            x = jnp.asarray(a)
            return jnp.tanh(x @ x)
        return work
    return [make(i) for i in range(N_TASKS)]


@pytest.mark.parametrize("slots,wave", [(1, True), (4, True), (4, False)])
def test_torch_dispatch_under_the_port_scheduler_matches(slots, wave):
    """The port's Scheduler + TorchDispatchExecutor against the reference's
    Scheduler + JaxDispatchExecutor: the same virtual times, states and
    retry lifecycle (the raising payload fails both attempts), and
    results within float32 rounding of XLA's."""
    def run(m, side):
        ex = (m.executor.TorchDispatchExecutor() if side == "port"
              else m.executor.JaxDispatchExecutor())
        rm = m.ResourceManager()
        rm.add_nodes(slots, slots=1)
        s = m.Scheduler(rm, profile=m.FAMILIES["inproc"], executor=ex,
                        config=m.SchedulerConfig(wave_batching=wave))
        job = m.Job.array(N_TASKS, payloads=_dispatch_payloads(side),
                          duration=0.01)
        job.max_restarts = 1
        s.submit(job)
        s.run()
        return ex, job, signature(s, [job])

    ref_ex, ref_job, ref_sig = run(REF, "jax")
    ex, job, sig = run(PORT, "port")
    assert sig == ref_sig
    assert job.tasks[RAISES].state.value == "failed"
    assert job.tasks[RAISES].attempts == 2
    assert job.state.value == "failed"
    assert list(ex.errors) == [(job.job_id, RAISES)]
    assert isinstance(ex.errors[(job.job_id, RAISES)], ValueError)
    assert sorted(k[1] for k in ex.results) == sorted(
        k[1] for k in ref_ex.results)
    by_index = {k[1]: v for k, v in ref_ex.results.items()}
    for (_, i), out in ex.results.items():
        np.testing.assert_allclose(out.numpy(), np.asarray(by_index[i]),
                                   rtol=1e-6, atol=1e-6)


def test_executor_interface_still_imports_from_executor():
    from repro_torch.core.executor import Executor
    from repro_torch.core.scheduler import Executor as SchedulerExecutor
    assert Executor is SchedulerExecutor


# --------------------------------------------------------- latency model
def test_latency_model_matches_the_reference():
    n = np.array([1, 4, 8, 48, 240, 1000], dtype=float)
    t = np.array([0.5, 1.0, 5.0, 30.0, 60.0, 2.0])
    rng = np.random.default_rng(4)
    per_proc = [list(rng.random(k) * 3 + 0.1) for k in (3, 7, 1, 12)]
    for t_s, a in ((2.2, 1.3), (0.5, 1.0), (33.0, 0.9)):
        pairs = [
            (port_lm.delta_t(n, t_s, a), ref_lm.delta_t(n, t_s, a)),
            (port_lm.total_runtime(n, 1.5, t_s, a),
             ref_lm.total_runtime(n, 1.5, t_s, a)),
            (port_lm.utilization_constant(t, n, t_s, a),
             ref_lm.utilization_constant(t, n, t_s, a)),
            (port_lm.utilization_approx(t, t_s),
             ref_lm.utilization_approx(t, t_s)),
            (port_lm.utilization_variable(per_proc, t_s, a),
             ref_lm.utilization_variable(per_proc, t_s, a)),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    dts = ref_lm.delta_t(n, 2.2, 1.3) * (1 + 0.01 * np.sin(n))
    fp, fr = port_lm.fit_power_law(n, dts), ref_lm.fit_power_law(n, dts)
    np.testing.assert_allclose([fp.t_s, fp.alpha_s, fp.r2],
                               [fr.t_s, fr.alpha_s, fr.r2], rtol=1e-12)
    assert str(fp) == str(fr)
    curve_t = np.linspace(0.1, 60, 40)
    curve_u = ref_lm.utilization_approx(curve_t, 2.0)
    means = [0.5, 3.0, 12.0, 45.0]
    np.testing.assert_allclose(
        port_lm.estimate_variable_from_constant(curve_t, curve_u, means),
        ref_lm.estimate_variable_from_constant(curve_t, curve_u, means),
        rtol=1e-12, atol=0)


# ------------------------------------------------------------ property
@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), nodes=st.integers(1, 6),
       slots=st.sampled_from((1, 2, 4)), wave=st.booleans(),
       policy=st.sampled_from((None, "backfill", "binpack", "locality")))
def test_random_job_mixes_match(seed, nodes, slots, wave, policy):
    def run(m):
        rng = random.Random(seed)
        rm = m.ResourceManager()
        rm.add_nodes(nodes, slots=slots)
        pol = None if policy is None else m.make_policy(policy)
        s = m.Scheduler(rm, policy=pol, profile=fast_profile(m),
                        config=m.SchedulerConfig(wave_batching=wave))
        jobs = []
        for _ in range(rng.randint(1, 12)):
            n = rng.randint(1, 6)
            width = rng.choice([w for w in (1, 2, 4) if w <= slots])
            j = m.Job.array(n, durations=[rng.choice((0.0, 0.5, rng.random()))
                                          for _ in range(n)],
                            request=m.ResourceRequest(slots=width),
                            priority=float(rng.randint(0, 1)))
            if jobs and rng.random() < 0.2:
                j.depends_on = (jobs[rng.randrange(len(jobs))].job_id,)
            jobs.append(j)
            s.submit(j)
        s.run()
        return signature(s, jobs)
    ref, port = both(run)
    assert port == ref


def test_chip_smoke_golden_constants_are_the_references():
    """chip_smoke.py's scheduler phase pins the port's virtual-time numbers
    on the card's host to constants; each equals the reference's own
    output here."""
    spec = importlib.util.spec_from_file_location("chip_smoke_consts",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    g = chip_smoke.SCHED_GOLDEN
    ref_qs = _reference("examples/quickstart.py", "ref_quickstart_g")
    assert g["quickstart_direct"] == ref_qs.run(False)
    assert g["quickstart_bundled"] == ref_qs.run(True)
    ns, dts = [], []
    for n, t in quickstart.FIT_GRID:
        rm = REF.ResourceManager()
        rm.add_nodes(ref_qs.P, slots=1)
        s = REF.Scheduler(rm, profile=REF.FAMILIES["slurm"])
        job = REF.Job.array(n * ref_qs.P, duration=t)
        s.submit(job)
        s.run()
        st = s.stats[job.job_id]
        ns.append(n)
        dts.append((st.last_end - st.submit_time) - n * t)
    assert (g["fit_n"], g["fit_dt"]) == (ns, dts)
    fit = ref_lm.fit_power_law(ns, dts)
    np.testing.assert_allclose(g["fit"], (fit.t_s, fit.alpha_s, fit.r2),
                               rtol=chip_smoke.SCHED_FIT_RTOL, atol=0)
    ref_bench = _reference("benchmarks/sched_throughput.py", "ref_bench_g")
    regime = next(r for r in ref_bench.FIFO_REGIMES
                  if r[0] == "table9_rapid_slurm")
    # the reference's row rounds to 3 decimals; its engine gives the
    # unrounded value through the same run
    rm = REF.ResourceManager()
    rm.add_nodes(1408, slots=1)
    s = REF.Scheduler(rm, profile=REF.FAMILIES["slurm"])
    s.submit(REF.Job.array(240 * 1408, duration=0.5))
    s.run()
    assert g["table9_rapid_slurm_makespan_s"] == max(
        st.last_end for st in s.stats.values())
    assert round(g["table9_rapid_slurm_makespan_s"], 3) == \
        ref_bench.run_regime(*regime)["virtual_makespan_s"]

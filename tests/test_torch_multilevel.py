"""Multilevel scheduling in the port against the reference, on the CPU:
``aggregate``, ``map_reduce`` and ``true_task_seconds`` build the same jobs,
run to the same JobStats and tasks (0 tolerance) through each package's
Scheduler, and the port's map-reduce example (torch.bincount payloads
through TorchDispatchExecutor) gives the reference example's histogram."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.examples import multilevel_scheduling  # noqa: E402
from torch_sched_parity import PORT, REF, both, signature  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _jobs(m, n, *, durations=None, mode="mimo", slots=8, per_slot=1):
    rng = np.random.default_rng(n)
    durs = (list(rng.random(n) * 2.0) if durations is None else durations)
    raw = m.Job.array(n, durations=durs, name="raw", user="u7",
                      queue="default", priority=1.0, max_restarts=2)
    cfg = m.MultilevelConfig(mode=mode, bundles_per_slot=per_slot)
    return raw, m.aggregate(raw, slots=slots, cfg=cfg)


@pytest.mark.parametrize("n,mode,slots,per_slot", [
    (100, "mimo", 8, 1), (100, "siso", 8, 1), (7, "mimo", 16, 1),
    (1000, "mimo", 12, 3), (1, "siso", 4, 2)])
def test_aggregate_builds_the_same_bundles(n, mode, slots, per_slot):
    (rr, rb), (pr, pb) = both(_jobs, n, mode=mode, slots=slots,
                              per_slot=per_slot)
    assert pb.n_tasks == rb.n_tasks
    assert [t.duration for t in pb.tasks] == [t.duration for t in rb.tasks]
    assert (pb.name, pb.user, pb.queue, pb.priority, pb.max_restarts) == (
        rb.name, rb.user, rb.queue, rb.priority, rb.max_restarts)
    assert PORT.multilevel.true_task_seconds(pr) == \
        REF.multilevel.true_task_seconds(rr)
    assert PORT.multilevel.bundle_durations([0.5, 1.0], PORT.MultilevelConfig(
        mode=mode)) == REF.multilevel.bundle_durations(
            [0.5, 1.0], REF.MultilevelConfig(mode=mode))


@pytest.mark.parametrize("wave", [True, False])
def test_bundled_and_direct_runs_match(wave):
    def run(m):
        rm = m.ResourceManager()
        rm.add_nodes(8, slots=1)
        s = m.Scheduler(rm, profile=m.FAMILIES["slurm"],
                        config=m.SchedulerConfig(wave_batching=wave))
        raw, bundled = _jobs(m, 200)
        direct = m.Job.array(200, durations=[t.duration for t in raw.tasks])
        for j in (direct, bundled):
            s.submit(j)
        s.run()
        return signature(s, [direct, bundled])
    ref, port = both(run)
    assert port == ref


def _payload_run(m):
    """map_reduce with payloads through the InlineExecutor: composed
    bundles, the reducer after every mapper."""
    seen = []

    def make(i):
        def work():
            seen.append(i)
            return i * i
        return work

    def reducer():
        return sum(seen)

    rm = m.ResourceManager()
    rm.add_nodes(4, slots=1)
    ex = m.executor.InlineExecutor()
    s = m.Scheduler(rm, profile=m.FAMILIES["inproc"], executor=ex)
    jobs = m.map_reduce(n_tasks=30, task_duration=0.25, slots=4,
                        payloads=[make(i) for i in range(30)],
                        reduce_payload=reducer, reduce_duration=0.5,
                        cfg=m.MultilevelConfig(mode="siso"), user="ana")
    for j in jobs:
        s.submit(j)
    s.run()
    mappers, red = jobs
    return (signature(s, jobs), seen,
            [ex.results[(mappers.job_id, b)] for b in range(
                mappers.n_tasks)], ex.results[(red.job_id, 0)],
            (mappers.name, red.name, mappers.user))


def test_map_reduce_with_payloads_matches():
    ref, port = both(_payload_run)
    assert port == ref
    sig, seen, bundles, total, names = port
    assert seen == list(range(30)) and total == sum(range(30))
    assert [len(b) for b in bundles] == [8, 8, 8, 6]
    assert names == ("map-mlsched", "map-mlsched-reduce", "ana")


def test_map_reduce_without_a_reducer_matches():
    def run(m):
        jobs = m.map_reduce(n_tasks=9, task_duration=1.0, slots=3)
        return [(j.n_tasks, [t.duration for t in j.tasks], j.depends_on)
                for j in jobs]
    ref, port = both(run)
    assert port == ref and len(port) == 1


def test_multilevel_example_matches_the_reference_example():
    spec = importlib.util.spec_from_file_location(
        "ref_multilevel_example", ROOT / "examples/multilevel_scheduling.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert (ref.N_SHARDS, ref.SLOTS) == (multilevel_scheduling.N_SHARDS,
                                         multilevel_scheduling.SLOTS)
    _, _, ref_shards = ref.make_payloads()
    shards = multilevel_scheduling.make_shards()
    assert all(np.array_equal(a, b) for a, b in zip(shards, ref_shards))
    res = multilevel_scheduling.main(["--device", "cpu"])
    assert res["device"] == "cpu" and res["bundles"] == ref.SLOTS
    assert res["completed"] == ref.SLOTS + 1
    assert res["total"] == ref.N_SHARDS * 2000
    ref.main()   # the reference's own run and asserts

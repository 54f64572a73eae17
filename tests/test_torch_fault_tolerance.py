"""The port's fault-tolerant training against the reference's: the
counterparts of tests/test_fault_tolerance.py's checkpoint, heartbeat,
elastic-plan and supervisor tests (its two compression tests have theirs
in test_torch_compression.py), each driven on both sides with the same
inputs; a supervised run around the port's real train step, bit-equal to
an uninterrupted run; and synchronous checkpoint writes."""
import dataclasses
import glob
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.distributed import fault_tolerance as ref_ft  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import RunConfig, get_smoke_config  # noqa: E402
from repro_torch.core.resources import NodeState, ResourceManager  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.distributed import fault_tolerance as ft  # noqa: E402
from repro_torch.launch.steps import build_train_step, init_train_state  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which are no
    faster on more threads, and the other test workers need the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 7, tree, extra={"step": 7})
    restored, extra = load_checkpoint(
        str(tmp_path), {"a": torch.zeros(3, 4),
                        "b": {"c": torch.zeros(5, dtype=torch.bfloat16)}})
    assert extra["step"] == 7
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    # the reference reads the port's step as its own
    ref, ref_extra = jax_load(str(tmp_path),
                              {"a": jnp.zeros((3, 4)),
                               "b": {"c": jnp.zeros((5,), jnp.bfloat16)}})
    assert ref_extra == extra
    np.testing.assert_array_equal(np.asarray(ref["a"]), tree["a"].numpy())
    assert str(ref["b"]["c"].dtype) == "bfloat16"


@pytest.mark.parametrize("side", ["port", "reference"])
def test_checkpoint_integrity_detection(tmp_path, side):
    path = save_checkpoint(str(tmp_path), 1, {"a": torch.arange(8.0)})
    leaf = glob.glob(path + "/leaf_*.npy")[0]
    arr = np.load(leaf)
    arr[0] += 1
    np.save(leaf, arr)
    with pytest.raises(IOError):
        if side == "port":
            load_checkpoint(str(tmp_path), {"a": torch.zeros(8)})
        else:
            jax_load(str(tmp_path), {"a": jnp.zeros((8,))})


@pytest.mark.parametrize("side", ["port", "reference"])
def test_uncommitted_checkpoint_ignored(tmp_path, side):
    save_checkpoint(str(tmp_path), 1, {"a": torch.arange(4.0)})
    torn = tmp_path / "step_00000002"   # a torn write at step 2
    torn.mkdir()
    (torn / "MANIFEST.json").write_text("{}")
    if side == "port":
        restored, _ = load_checkpoint(str(tmp_path), {"a": torch.zeros(4)})
    else:
        restored, _ = jax_load(str(tmp_path), {"a": jnp.zeros((4,))})
    np.testing.assert_array_equal(np.asarray(restored["a"]),
                                  np.arange(4.0, dtype=np.float32))


@pytest.mark.parametrize("async_write", [True, False])
def test_manager_async_and_retention(tmp_path, async_write):
    kept = {}
    for side, mgr_cls, full in (
            ("port", CheckpointManager, lambda s: torch.full((4,), float(s))),
            ("reference", JaxManager, lambda s: jnp.full((4,), float(s)))):
        d = tmp_path / side
        mgr = mgr_cls(str(d), keep=2, async_write=async_write)
        for s in (10, 20, 30, 40):
            mgr.save(s, {"w": full(s)})
        mgr.wait()
        assert mgr.latest_step() == 40
        kept[side] = sorted(p.name for p in d.glob("step_*"))
    assert kept["port"] == kept["reference"] == ["step_00000030",
                                                 "step_00000040"]
    restored, _ = CheckpointManager(str(tmp_path / "port")).restore(
        {"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.full((4,), 40.0))


def test_synchronous_write_raises_at_once(tmp_path):
    """async_write=False: a failed write raises from save itself, on both
    sides; asynchronous, it raises from wait."""
    for side, mgr_cls, tree in (
            ("port", CheckpointManager, {"w": torch.zeros(4)}),
            ("reference", JaxManager, {"w": jnp.zeros((4,))})):
        for async_write in (False, True):
            d = tmp_path / f"{side}_{async_write}"
            mgr = mgr_cls(str(d), async_write=async_write)
            shutil.rmtree(d)
            d.write_text("not a directory")
            if not async_write:
                with pytest.raises(OSError):
                    mgr.save(1, tree)
            else:
                mgr.save(1, tree)
                with pytest.raises(OSError):
                    mgr.wait()


# each scenario: a list of ("beat", slice, now), ("check", now) and
# ("fail", slice) events, run on both monitors
HEARTBEAT_SCENARIOS = {
    "dead_slice": [("beat", i, 0.0) for i in range(4)]
    + [("beat", 0, 10.0), ("beat", 1, 10.0), ("beat", 2, 10.0),
       ("check", 10.0)],
    "rejoin": [("beat", i, 0.0) for i in range(3)]
    + [("check", 6.0), ("beat", 1, 7.0), ("check", 8.0), ("beat", 0, 9.0),
       ("check", 12.5), ("check", 20.0)],
    "fail_then_beat": [("beat", i, 1.0) for i in range(5)]
    + [("fail", 3), ("check", 2.0), ("beat", 3, 3.0), ("fail", 0),
       ("check", 5.9), ("check", 6.1)],
    "at_the_timeout": [("beat", 0, 0.0), ("beat", 1, 0.5), ("check", 5.0),
                       ("check", 5.25)],
}


@pytest.mark.parametrize("name", sorted(HEARTBEAT_SCENARIOS))
def test_heartbeat_detects_dead_slice(name):
    events = HEARTBEAT_SCENARIOS[name]
    n = 1 + max(e[1] for e in events if e[0] != "check")
    trace = {}
    for side, mod in (("port", ft), ("reference", ref_ft)):
        mon = mod.HeartbeatMonitor(n_slices=n, timeout=5.0)
        out = []
        for ev in events:
            if ev[0] == "beat":
                mon.beat(ev[1], now=ev[2])
            elif ev[0] == "fail":
                mon.fail(ev[1])
            else:
                out.append(mon.check(now=ev[1]))
            out.append(sorted(mon.healthy_slices()))
        trace[side] = out
    assert trace["port"] == trace["reference"]
    if name == "dead_slice":
        assert trace["port"][-2:] == [[3], [0, 1, 2]]


def test_resource_manager_liveness_keeps_serving_semantics():
    """A DOWN lane refuses work, forgets its tasks, and takes work again
    once it has rejoined."""
    from repro_torch.core import Job

    rm = ResourceManager()
    rm.add_nodes(2, slots=1)
    t = Job.array(1).tasks[0]
    rm.allocate(t, 0)
    assert rm.mark_down(0) == [t.key]
    assert rm.nodes[0].state is NodeState.DOWN
    assert rm.nodes[0].free_slots == 1 and not rm.nodes[0].running
    u = Job.array(1).tasks[0]
    with pytest.raises(RuntimeError):
        rm.allocate(u, 0)
    rm.heartbeat(0, 1.0)
    rm.allocate(u, 0)
    assert [n.node_id for n in rm.up_nodes()] == [0, 1]


def test_elastic_plan_shrinks_data_axis():
    plan = ft.ElasticPlan.plan(healthy_slices=12, slices_per_data_shard=1,
                               model_parallel=16, global_batch=256)
    assert plan.data_parallel == 12
    assert plan.global_batch == 252   # nearest multiple of 12
    plan2 = ft.ElasticPlan.plan(healthy_slices=16, slices_per_data_shard=1,
                                model_parallel=16, global_batch=256)
    assert plan2.global_batch == 256 and plan2.per_replica_batch == 16


@pytest.mark.parametrize("spd", [1, 2, 3, 4])
def test_elastic_plan_equals_reference_over_a_grid(spd):
    for healthy in range(1, 65):
        for gb in (1, 2, 7, 8, 12, 96, 255, 256, 1000):
            for mp in (1, 16):
                got = ft.ElasticPlan.plan(healthy, spd, mp, gb)
                want = ref_ft.ElasticPlan.plan(healthy, spd, mp, gb)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (
                    healthy, spd, mp, gb)


def _toy_run(side, tmp_path, fails, total, every):
    """The reference test's toy run on one side: state {"w", "step"}, a
    deterministic "gradient" of step + 1."""
    if side == "port":
        mod, mgr_cls = ft, CheckpointManager
        state = {"w": torch.zeros(4), "step": torch.tensor(0, dtype=torch.int32)}

        def train_fn(state, step):
            return {"w": state["w"] + float(step + 1),
                    "step": torch.tensor(step + 1, dtype=torch.int32)}
    else:
        mod, mgr_cls = ref_ft, JaxManager
        state = {"w": jnp.zeros((4,), jnp.float32), "step": jnp.int32(0)}

        def train_fn(state, step):
            return {"w": state["w"] + jnp.float32(step + 1),
                    "step": jnp.int32(step + 1)}

    mon = mod.HeartbeatMonitor(n_slices=4)
    for i in range(4):
        mon.beat(i)
    sup = mod.TrainSupervisor(mgr_cls(str(tmp_path / side),
                                      async_write=False),
                              mon, global_batch=8, checkpoint_every=every)
    pending = dict(fails)
    plans = []
    state, report = sup.run(
        state, train_fn, start_step=0, total_steps=total,
        failure_injector=lambda s: pending.pop(s, None),
        remesh_fn=lambda plan, st: plans.append(
            dataclasses.asdict(plan)) or st)
    return (np.asarray(state["w"]), int(state["step"]),
            dataclasses.asdict(report), plans)


@pytest.mark.parametrize("fails,total,every", [
    ({12: 2}, 20, 5),                # the reference test's schedule
    ({3: 0}, 10, 5),                 # before the first checkpoint
    ({5: 1, 13: 3}, 20, 4),          # two failures
    ({6: 2}, 8, 4),                  # chip_smoke's fault phase
], ids=["step12", "no_checkpoint_yet", "two_failures", "fault_phase"])
def test_supervisor_restores_after_failure(tmp_path, fails, total, every):
    w, step, report, plans = _toy_run("port", tmp_path, fails, total, every)
    rw, rstep, rreport, rplans = _toy_run("reference", tmp_path, fails,
                                          total, every)
    assert report == rreport and plans == rplans
    np.testing.assert_array_equal(w, rw)
    assert step == rstep == total
    # bit-exact against a failure-free run
    np.testing.assert_array_equal(w, np.full(4, total * (total + 1) / 2,
                                             np.float32))
    if fails == {12: 2}:
        assert report["failures"] == report["restores"] == 1
        assert report["remeshes"][0][1] == 3   # dp shrank to 3


def test_supervisor_around_the_train_step_is_bit_exact(tmp_path):
    """The port's real train step on the phi4 smoke config: 8 steps with
    a checkpoint every 4 and slice 2 failing at step 6 end bit-equal to 8
    uninterrupted steps from the same state."""
    cfg = get_smoke_config("phi4_mini_3_8b")
    run = RunConfig(model=cfg, seq_len=32, global_batch=2,
                    learning_rate=1e-3, warmup_steps=2, total_steps=8)
    step_fn = build_train_step(cfg, run=run, device="cpu")
    source = SyntheticTokens(cfg.vocab_size, run.seq_len, run.global_batch)

    def train_fn(state, step):
        return step_fn(state, source.batch_at(step))[0]

    ref = init_train_state(cfg, run, "cpu")
    for s in range(8):
        ref = train_fn(ref, s)
    mon = ft.HeartbeatMonitor(n_slices=4)
    for i in range(4):
        mon.beat(i)
    sup = ft.TrainSupervisor(CheckpointManager(str(tmp_path), keep=2,
                                               async_write=False),
                             mon, global_batch=8, checkpoint_every=4)
    fails = {6: 2}
    state, report = sup.run(init_train_state(cfg, run, "cpu"), train_fn,
                            0, 8, failure_injector=lambda s: fails.pop(s, None))
    assert (report.failures, report.restores, report.remeshes,
            report.final_step, report.steps_run) == (1, 1, [(4, 3)], 8, 10)
    assert all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(ref)))
    assert int(state["opt"].step) == 8


def test_synchronous_write_error_does_not_stick(tmp_path):
    """After a failed synchronous write the next save writes. (The
    reference keeps the error and raises it again from the next save's
    wait, writing nothing: ROADMAP Queue 3.)"""
    d = tmp_path / "ckpt"
    mgr = CheckpointManager(str(d), async_write=False)
    shutil.rmtree(d)
    d.write_text("not a directory")
    with pytest.raises(OSError):
        mgr.save(1, {"w": torch.zeros(4)})
    d.unlink()
    d.mkdir()
    mgr.save(2, {"w": torch.ones(4)})
    assert mgr.latest_step() == 2
    ref = JaxManager(str(tmp_path / "ref"), async_write=False)
    shutil.rmtree(tmp_path / "ref")
    (tmp_path / "ref").write_text("not a directory")
    with pytest.raises(OSError):
        ref.save(1, {"w": jnp.zeros((4,))})
    (tmp_path / "ref").unlink()
    (tmp_path / "ref").mkdir()
    with pytest.raises(OSError):
        ref.save(2, {"w": jnp.ones((4,))})
    assert ref.latest_step() is None

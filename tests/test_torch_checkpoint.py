"""The port's checkpoints against the reference's: the same on-disk layout
both ways (bf16 leaves as uint16 bit patterns, leaves in jax.tree_util's
order, blake2 digests, COMMIT last), and bit-exact restarts of training."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import checkpoint as ref_ckpt  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.configs import RunConfig, get_smoke_config  # noqa: E402
from repro_torch.launch.steps import init_train_state  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from torch_parity import models  # noqa: E402


def _ref_state(arch="jamba_v01_52b"):
    """A reference train state (bf16 params, float32 moments, int32 step)
    with nonzero moments and step, and the port's state of the same
    structure from other values."""
    jm, jp, pm, pp = models(arch, "bfloat16")
    opt = RefAdamW()
    js = {"params": jp, "opt": opt.init(jp)}
    grads = jax.tree_util.tree_map(jnp.ones_like, jp)
    params, o, _ = jax.jit(opt.update)(grads, js["opt"], jp)
    js = {"params": params, "opt": o}
    ts = {"params": pm.init(7, device="cpu")}
    ts["opt"] = AdamW().init(ts["params"])
    return js, ts


def _assert_bit_equal(jtree, ttree):
    jl, tl = jax.tree_util.tree_leaves(jtree), tree_lib.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).split(".")[1]
        assert a.shape == tuple(b.shape)
        if b.dtype == torch.bfloat16:
            bits = b.view(torch.int16).numpy().view(np.uint16)
            assert bits.tobytes() == a.view(np.uint16).tobytes()
        else:
            assert b.numpy().tobytes() == a.tobytes()


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    js, ts = _ref_state()
    ref_ckpt.save_checkpoint(str(tmp_path), 3, js, extra={"step": 3})
    got, extra = load_checkpoint(str(tmp_path), ts)
    assert extra == {"step": 3}
    assert got["params"]["embed"]["tok_embed"] is (
        ts["params"]["embed"]["tok_embed"])          # restored in place
    _assert_bit_equal(js, got)
    assert int(got["opt"].step) == 1


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    js, ts = _ref_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, ts, extra={"step": 5})
    mgr.wait()
    got, extra = ref_ckpt.load_checkpoint(str(tmp_path), js)
    assert extra == {"step": 5}
    _assert_bit_equal(got, ts)
    manifest = json.loads((tmp_path / "step_00000005" / "MANIFEST.json")
                          .read_text())
    assert {m["dtype"] for m in manifest["leaves"]} == {
        "bfloat16", "float32", "int32"}


def test_manifest_digests_commit_and_retention(tmp_path):
    _, ts = _ref_state("phi4_mini_3_8b")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, ts, extra={"step": step})
    mgr.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000002", "step_00000003"]
    ckpt = tmp_path / "step_00000003"
    manifest = json.loads((ckpt / "MANIFEST.json").read_text())
    for meta, leaf in zip(manifest["leaves"], tree_lib.leaves(ts)):
        arr = np.load(ckpt / meta["file"])
        assert meta["digest"] == ckpt_mod._digest(arr)
        assert meta["shape"] == list(leaf.shape)
    # a step without COMMIT is ignored
    (tmp_path / "step_00000009").mkdir()
    assert latest_step(str(tmp_path)) == mgr.latest_step() == 3
    # a corrupted leaf fails the integrity check
    leaf = ckpt / manifest["leaves"][-1]["file"]
    arr = np.load(leaf)
    arr.reshape(-1)[0] += 1
    np.save(leaf, arr)
    with pytest.raises(IOError, match="integrity"):
        load_checkpoint(str(tmp_path), ts)


def test_save_snapshots_before_the_state_moves(tmp_path):
    """An async save writes the values of the moment it was called, even
    when the state changes in place right after."""
    _, ts = _ref_state("phi4_mini_3_8b")
    before = [t.clone() for t in tree_lib.leaves(ts)]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, ts)
    with torch.no_grad():
        for t in tree_lib.leaves(ts):
            t.add_(1)
    mgr.wait()
    got, _ = load_checkpoint(str(tmp_path), tree_lib.map_tree(
        torch.zeros_like, ts))
    for a, b in zip(tree_lib.leaves(got), before):
        assert torch.equal(a, b)


def test_load_refuses_a_mismatched_tree(tmp_path):
    _, ts = _ref_state("phi4_mini_3_8b")
    save_checkpoint(str(tmp_path), 1, ts)
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(str(tmp_path), ts["params"])
    other = init_train_state(get_smoke_config("gemma_2b"), device="cpu")
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), other)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "jamba_v01_52b"])
def test_restart_is_bit_exact(tmp_path, arch):
    """4 steps straight == 2 steps, checkpoint, restore into a fresh
    state, 2 more: every leaf bit for bit."""
    cfg = get_smoke_config(arch)
    run = RunConfig(model=cfg, seq_len=16, global_batch=2,
                    learning_rate=1e-3, warmup_steps=1, total_steps=4)
    straight, losses = train(cfg, run, 4, device="cpu", log_every=100)
    d = str(tmp_path / "run")
    _, first = train(cfg, run, 2, device="cpu", ckpt_dir=d, log_every=100)
    fresh = init_train_state(cfg, RunConfig(model=cfg, seed=9), "cpu")
    resumed, second = train(cfg, run, 4, device="cpu", ckpt_dir=d,
                            log_every=100, state=fresh)
    assert first + second == losses
    for a, b in zip(tree_lib.leaves(straight), tree_lib.leaves(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert latest_step(d) == 4

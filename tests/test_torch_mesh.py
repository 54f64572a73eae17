"""The port's step builders on a torch mesh: the counterpart of
tests/test_steps_integration.py, on a gloo host mesh (one device).

Train steps on the mesh equal the meshless port step bit for bit (phi4,
Jamba, Granite; xLSTM's logsigmoid backward is written out on a mesh and
its gradients agree to 1e-6 of the largest gradient), and equal the
reference's ``build_train_step(cfg, make_host_mesh(), shape).jit()`` at
tests/test_torch_steps.py's tolerance. The prefill and decode builders
and k-step decode run on the mesh with the meshless results. Each test
sets up its group in a fixture and tears it down.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticTokens, TokenPipeline  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_decode_step, build_prefill_step, build_train_step)
from repro_torch.optim import AdamW  # noqa: E402
from torch_parity import f32, models  # noqa: E402

B, S, STEPS = 2, 32, 2
STATE_TOL = 1e-5      # tests/test_torch_steps.py's, same steps and rate
KW = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)


@pytest.fixture
def host_mesh():
    mesh_lib.init_group("gloo", 1)
    try:
        yield mesh_lib.make_host_mesh("cpu")
    finally:
        mesh_lib.destroy_group()


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _clone(state):
    return tree_lib.map_tree(lambda t: t.detach().clone(), state)


def _source(cfg):
    return SyntheticTokens(cfg.vocab_size, S, B, seed=0)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "jamba_v01_52b",
                                  "granite_moe_1b_a400m"])
def test_train_step_on_the_mesh(arch, host_mesh):
    """Two steps: the mesh state is the meshless state bit for bit, and
    both agree with the reference's step on its host mesh."""
    from repro.configs.base import RunConfig as RefRun
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch.mesh import make_host_mesh as ref_host_mesh
    from repro.launch.steps import build_train_step as ref_build
    from repro.optim import AdamW as RefAdamW

    jm, jp, pm, pp = models(arch, "float32")
    run = RunConfig(model=pm.cfg, **KW)
    plain = {"params": pp, "opt": AdamW().init(pp)}
    meshed = _clone(plain)
    plain_step = build_train_step(pm.cfg, run=run, device="cpu")
    mesh_step = build_train_step(pm.cfg, run=run, device="cpu",
                                 mesh=host_mesh)
    ref_step = ref_build(jm.cfg, ref_host_mesh(), RefShape("t", "train", S, B),
                         run=RefRun(model=jm.cfg, **KW)).jit()
    js = {"params": jp, "opt": RefAdamW().init(jp)}
    source = _source(pm.cfg)
    for i in range(STEPS):
        batch = source.batch_at(i)
        plain, pmet = plain_step(plain, batch)
        meshed, mmet = mesh_step(meshed, batch)
        js, jmet = ref_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
        for key in pmet:
            assert not hasattr(mmet[key], "placements")
            assert torch.equal(pmet[key], mmet[key]), key
            np.testing.assert_allclose(float(mmet[key]), float(jmet[key]),
                                       rtol=STATE_TOL, atol=STATE_TOL)
    assert all(hasattr(t, "placements")
               for t in tree_lib.leaves(meshed["params"]))
    for a, b in zip(tree_lib.leaves(plain), tree_lib.leaves(meshed)):
        assert torch.equal(a, _local(b))
    jleaves = jax.tree_util.tree_leaves(js["params"])
    for a, b in zip(jleaves, tree_lib.leaves(meshed["params"])):
        np.testing.assert_allclose(f32(_local(b)), np.asarray(a, np.float32),
                                   rtol=STATE_TOL, atol=STATE_TOL)


def test_xlstm_gradients_on_the_mesh(host_mesh):
    """xLSTM on a mesh takes logsigmoid's backward as ATen writes it
    (DTensor has no strategy for log_sigmoid_backward), its forward too:
    the loss agrees with the meshless one to 1e-6, every gradient element
    to 1e-6 of the largest gradient."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.steps import (batch_to, on_mesh, rules_for,
                                          shard_batch)

    _, _, pm, pp = models("xlstm_1_3b", "float32")
    batch = batch_to(_source(pm.cfg).batch_at(0), "cpu")
    leaves = [t.requires_grad_(True) for t in tree_lib.leaves(pp)]
    loss, _ = pm.loss(pp, batch)
    want = torch.autograd.grad(loss, leaves)
    rules = rules_for(host_mesh, pm.cfg)
    with on_mesh(host_mesh, rules):
        params = shd.param_shardings(_clone(pp), host_mesh, rules)
        mleaves = [t.requires_grad_(True) for t in tree_lib.leaves(params)]
        mloss, _ = pm.loss(params, shard_batch(batch, host_mesh, rules))
        got = torch.autograd.grad(mloss, mleaves)
    # the mesh's logsigmoid is ATen's formula written out: ~1 ulp apart
    torch.testing.assert_close(_local(mloss), loss, rtol=1e-6, atol=0)
    # relative to the largest gradient: sLSTM's input-gate bias has a
    # gradient of ~3e-10 (a cancellation), where any rounding is O(1)
    scale = max(float(a.abs().max()) for a in want)
    worst = max(float((a - _local(b)).abs().max()) for a, b in zip(want, got))
    assert worst <= 1e-6 * scale, (worst, scale)


def test_prefill_and_decode_on_the_mesh(host_mesh):
    """test_steps_integration.py::test_prefill_and_decode_builders_run on
    the mesh: the meshless step's logits and caches, and k-step decode
    equal to k single steps on the mesh."""
    _, _, pm, pp = models("phi4_mini_3_8b", "float32")
    cfg = pm.cfg
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    shape = ShapeConfig("p", "prefill", 32, 2)
    logits, caches = build_prefill_step(cfg, device="cpu")(
        pp, {"tokens": toks})
    mlogits, mcaches = build_prefill_step(cfg, device="cpu", mesh=host_mesh,
                                          shape=shape)(pp, {"tokens": toks})
    assert mlogits.shape == (2, cfg.padded_vocab)
    assert torch.equal(logits, _local(mlogits))
    for a, b in zip(tree_lib.leaves(caches), tree_lib.leaves(mcaches)):
        assert torch.equal(a, _local(b))
    token = torch.zeros((2, 1), dtype=torch.long)
    dshape = ShapeConfig("d", "decode", 32, 2)
    lg, caches = build_decode_step(cfg)(pp, token, caches, 31)
    mlg, mcaches = build_decode_step(cfg, mesh=host_mesh, shape=dshape)(
        pp, token, mcaches, 31)
    assert torch.equal(lg, _local(mlg))
    assert bool(torch.isfinite(_local(mlg)).all())
    # k-step decode on the mesh == k single mesh steps
    _, c1 = build_prefill_step(cfg, device="cpu", mesh=host_mesh)(
        pp, {"tokens": toks[:, :8]})
    _, c2 = build_prefill_step(cfg, device="cpu", mesh=host_mesh)(
        pp, {"tokens": toks[:, :8]})
    one = build_decode_step(cfg, mesh=host_mesh, shape=dshape)
    last = torch.as_tensor(toks[:, -1:])
    for i in range(3):
        lg1, c1 = one(pp, last, c1, 8 + i)
        last = _local(lg1).argmax(dim=-1, keepdim=True)
    lg3, c2 = build_decode_step(cfg, steps_per_dispatch=3, mesh=host_mesh,
                                shape=dshape)(pp, torch.as_tensor(
                                    toks[:, -1:]), c2, 8)
    assert torch.equal(_local(lg1), _local(lg3))


def test_kernel_path_on_the_mesh_runs_the_plain_versions(host_mesh):
    """use_kernel on a mesh of one device: the kernels' entry points run on
    the local shards (their plain versions on the CPU) and give the
    meshless kernel path's logits."""
    _, _, pm, pp = models("jamba_v01_52b", "float32")
    toks = np.random.default_rng(1).integers(0, pm.cfg.vocab_size, (1, 16))
    want, _ = build_prefill_step(pm.cfg, use_kernel=True, device="cpu")(
        pp, {"tokens": toks})
    got, _ = build_prefill_step(pm.cfg, use_kernel=True, device="cpu",
                                mesh=host_mesh)(pp, {"tokens": toks})
    assert torch.equal(want, _local(got))


def test_pipeline_shards_batches(host_mesh):
    source = SyntheticTokens(100, 8, 4, seed=3)
    pipe = TokenPipeline(source, device="cpu", mesh=host_mesh)
    try:
        step, batch = next(pipe)
    finally:
        pipe.close()
    want = source.batch_at(0)
    for k, v in batch.items():
        assert hasattr(v, "placements")
        assert np.array_equal(_local(v).numpy(), want[k])


def test_trainer_on_the_host_mesh(host_mesh):
    """launch/train.py's loop with a mesh: the losses of the meshless run."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                              dtype="float32")
    run = RunConfig(model=cfg, seq_len=16, global_batch=2)
    _, plain = train(cfg, run, 3, device="cpu", log_every=100)
    _, meshed = train(cfg, run, 3, device="cpu", log_every=100,
                      mesh=host_mesh)
    assert plain == meshed


def test_production_mesh_needs_torchrun():
    """--mesh single without torchrun at 256 ranks raises; the mesh is
    never shrunk."""
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--smoke", "--device", "cpu", "--steps", "1",
                    "--mesh", "single"])
    with pytest.raises(RuntimeError, match="512"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
    assert not torch.distributed.is_initialized()

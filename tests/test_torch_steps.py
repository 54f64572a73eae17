"""The port's step functions against the reference's launch/steps.py:
three train steps of every architecture, the prefill and decode steps,
k-step aggregated decode, and head padding for tensor parallelism (the port's
counterparts of tests/test_steps_integration.py)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_decode_step, build_prefill_step, build_train_step,
    pad_heads_for_tp)
from torch_parity import f32, models  # noqa: E402

B, S, STEPS = 2, 32, 3
# float32 parameters and moments after 3 steps at lr 1e-4: each step moves
# a parameter by up to ~1e-4 (Adam's update is ~±1 wherever the gradient is
# not tiny), and the gradients agree to ~1e-6 of their leaf's scale
# (tests/test_torch_train.py). Where a gradient element is itself near
# that noise, Adam's normalised update can differ by O(1): at lr 1e-3 two
# of Jamba's 8,192 w_up elements then differ by 3.1e-5, so the rate stays
# at 1e-4 and the states agree to 1e-5
STATE_TOL = 1e-5


def _source(cfg, seed=0):
    nf = 8 if cfg.frontend != "none" else 0
    return SyntheticTokens(cfg.vocab_size, S, B, seed=seed,
                           frontend_dim=cfg.frontend_dim if nf else 0,
                           frontend_tokens=nf)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_steps_match_reference(arch):
    """Three steps of build_train_step, both sides from the same weights
    and batches, at lr 1e-4 from the first step (warmup 1): parameters, m,
    v and the step's metrics agree."""
    from repro.configs.base import RunConfig as RefRun
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_train_step as ref_build
    from repro.optim import AdamW as RefAdamW
    from repro_torch.optim import AdamW

    jm, jp, pm, pp = models(arch, "float32")
    cfg = jm.cfg
    kw = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)
    ref_step = ref_build(cfg, make_host_mesh(), RefShape("t", "train", S, B),
                         run=RefRun(model=cfg, **kw)).jit()
    # no shape: the frontend archs get 8 stub embeddings, not input_specs'
    # 256 or 64
    port_step = build_train_step(pm.cfg, run=RunConfig(model=pm.cfg, **kw),
                                 device="cpu")
    js = {"params": jp, "opt": RefAdamW().init(jp)}
    ts = {"params": pp, "opt": AdamW().init(pp)}
    source = _source(cfg)
    for i in range(STEPS):
        batch = source.batch_at(i)
        js, jmet = ref_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tmet = port_step(ts, batch)
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=STATE_TOL, atol=STATE_TOL,
                                       err_msg=key)
    assert int(ts["opt"].step) == int(js["opt"].step) == STEPS
    for tree in ("params", "m", "v"):
        j = js["params"] if tree == "params" else getattr(js["opt"], tree)
        t = ts["params"] if tree == "params" else getattr(ts["opt"], tree)
        paths = jax.tree_util.tree_leaves_with_path(j)
        for (path, a), b in zip(paths, tree_lib.leaves(t)):
            np.testing.assert_allclose(
                f32(b), np.asarray(a, np.float32), rtol=STATE_TOL,
                atol=STATE_TOL, err_msg=f"{tree}{jax.tree_util.keystr(path)}")


def test_train_step_checks_the_batch_shape():
    _, _, pm, pp = models("phi4_mini_3_8b", "float32")
    step = build_train_step(pm.cfg, ShapeConfig("t", "train", S, B),
                            device="cpu")
    from repro_torch.optim import AdamW
    state = {"params": pp, "opt": AdamW().init(pp)}
    batch = _source(pm.cfg).batch_at(0)
    batch = {k: v[:, :S - 1] for k, v in batch.items()}
    with pytest.raises(ValueError, match="batch shapes"):
        step(state, batch)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "internvl2_2b",
                                  "musicgen_large"])
def test_train_input_specs_match_reference(arch):
    from repro.configs.base import ShapeConfig as RefShape

    jm, _, pm, _ = models(arch, "bfloat16")
    specs = jm.input_specs(RefShape("s", "train", 16, 2))
    ours = pm.input_specs(ShapeConfig("s", "train", 16, 2))
    assert sorted(specs) == sorted(ours)
    for name, spec in specs.items():
        shape, dtype = ours[name]
        assert tuple(spec.shape) == shape, name
        assert str(spec.dtype) == str(dtype).split(".")[1], name
    with pytest.raises(ValueError):
        pm.input_specs(ShapeConfig("s", "decode", 16, 2))


def test_prefill_and_decode_builders_run():
    """tests/test_steps_integration.py::test_prefill_and_decode_builders_run
    on the port: shapes and finite logits, and the same logits as the
    reference's steps on the same weights."""
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_decode_step as ref_decode
    from repro.launch.steps import build_prefill_step as ref_prefill
    from repro.configs.base import ShapeConfig as RefShape

    jm, jp, pm, pp = models("phi4_mini_3_8b", "float32")
    cfg = pm.cfg
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    pre = build_prefill_step(cfg, device="cpu")
    logits, caches = pre(pp, {"tokens": toks})
    assert logits.shape == (2, cfg.padded_vocab)
    dec = build_decode_step(cfg)
    lg, caches = dec(pp, torch.zeros((2, 1), dtype=torch.long), caches, 31)
    assert lg.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(lg).all())

    mesh = make_host_mesh()
    jl, jc = ref_prefill(jm.cfg, mesh, RefShape("p", "prefill", 32, 2)).jit()(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    np.testing.assert_allclose(f32(logits), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    jlg, _ = ref_decode(jm.cfg, mesh, RefShape("d", "decode", 32, 2)).jit()(
        jp, jnp.zeros((2, 1), jnp.int32), jc, jnp.int32(31))
    np.testing.assert_allclose(f32(lg), np.asarray(jlg), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("k", [2, 3])
def test_multistep_decode_matches_stepwise(k):
    """k greedy steps in one call == k sequential decode steps, and == the
    reference's steps_per_dispatch=k decode step on the same weights."""
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_decode_step as ref_decode
    from repro.configs.base import ShapeConfig as RefShape

    jm, jp, pm, pp = models("gemma_2b", "float32")
    toks = np.random.default_rng(1).integers(0, pm.cfg.vocab_size, (2, 8))
    tt = torch.from_numpy(toks)
    _, caches = pm.prefill(pp, tt, max_len=32)
    last = tt[:, -1:]
    for i in range(k):
        lg_ref, caches = pm.decode_step(pp, last, caches, 8 + i)
        last = lg_ref.argmax(dim=-1, keepdim=True)

    _, caches2 = pm.prefill(pp, tt, max_len=32)
    lg_multi, caches2 = build_decode_step(pm.cfg, steps_per_dispatch=k)(
        pp, tt[:, -1:], caches2, 8)
    assert torch.equal(lg_multi, lg_ref)
    for a, b in zip(tree_lib.leaves(caches), tree_lib.leaves(caches2)):
        assert torch.equal(a, b)

    _, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), max_len=32)
    jl, _ = ref_decode(jm.cfg, make_host_mesh(), RefShape("d", "decode", 32, 2),
                       steps_per_dispatch=k).jit()(
        jp, jnp.asarray(toks[:, -1:], jnp.int32), jc, jnp.int32(8))
    np.testing.assert_allclose(f32(lg_multi), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_pad_heads_for_tp_properties():
    """tests/test_steps_integration.py::test_pad_heads_for_tp_properties on
    the port, and the same padded configs as the reference's."""
    from repro.configs import get_config as ref_config
    from repro.launch.steps import pad_heads_for_tp as ref_pad

    cfg = get_config("phi4_mini_3_8b")
    assert pad_heads_for_tp(cfg, 1) == cfg

    class FakeMesh:
        axis_names = ("data", "model")
        devices = np.empty((1, 16))

    p = pad_heads_for_tp(get_config("phi4_mini_3_8b"), 16)
    assert p.n_heads == 32 and p.n_heads % 16 == 0
    assert p.n_heads % p.n_kv_heads == 0
    for arch in ("arctic_480b", "gemma_2b", "codeqwen15_7b", "phi4_mini_3_8b"):
        ours = pad_heads_for_tp(get_config(arch), 16)
        assert ours.n_heads % 16 == 0 and ours.n_heads % ours.n_kv_heads == 0
        theirs = ref_pad(ref_config(arch), FakeMesh())
        assert (ours.n_heads, ours.head_dim) == (theirs.n_heads,
                                                 theirs.head_dim)
    assert pad_heads_for_tp(get_config("codeqwen15_7b"), 16).n_heads == 32
    assert dataclasses.replace(cfg) == pad_heads_for_tp(cfg, 8)

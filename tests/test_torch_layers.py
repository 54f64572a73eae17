"""Primitive layers of the port against the JAX reference on the same inputs."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from torch_parity import f32, port_config  # noqa: E402

RNG = np.random.default_rng(7)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(shape, dtype, scale=1.0):
    x = (RNG.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(TORCH_DT[dtype])


def _close(t, j, dtype):
    np.testing.assert_allclose(f32(t), f32(j), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    xj, xt = _pair((2, 5, 64), dtype, 3.0)
    sj, st = _pair((64,), "float32")
    out = tl.rmsnorm({"scale": st}, xt, 1e-5)
    assert out.dtype == xt.dtype
    _close(out, jl.rmsnorm({"scale": sj}, xj, 1e-5), dtype)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_lane", [False, True])
def test_apply_rope_interleaved(fraction, dtype, per_lane):
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                              rope_fraction=fraction)
    B, S, H, hd = 3, (1 if per_lane else 9), 4, cfg.resolved_head_dim
    xj, xt = _pair((B, S, H, hd), dtype)
    pos = (np.array([[5], [17], [300]], np.int32) if per_lane
           else np.arange(S, dtype=np.int32)[None])
    out = tl.apply_rope(xt, torch.from_numpy(pos), port_config(cfg))
    exp = jl.apply_rope(xj, jnp.asarray(pos), cfg)
    assert out.dtype == xt.dtype and tuple(out.shape) == exp.shape
    _close(out, exp, dtype)
    if fraction < 1.0:  # the tail of head_dim passes through unrotated
        rot = int(hd * fraction)
        np.testing.assert_array_equal(f32(out)[..., rot:], f32(xt)[..., rot:])


def test_apply_rope_is_not_rotate_half():
    cfg = port_config(get_smoke_config("phi4_mini_3_8b"))
    x = torch.zeros(1, 1, 1, cfg.resolved_head_dim)
    x[..., 0] = 1.0   # first interleaved pair is (x0, x1)
    out = tl.apply_rope(x, torch.tensor([[1]]), cfg)
    # a rotation of the pair (0, 1) by angle 1 * inv[0] = 1 rad
    np.testing.assert_allclose(out[0, 0, 0, :2].numpy(),
                               [np.cos(1.0), np.sin(1.0)], rtol=1e-6)
    assert float(out[0, 0, 0, 2:].abs().max()) == 0.0


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn(act, dtype):
    d, f = 32, 64
    pj, pt = {}, {}
    names = ["w_up", "w_down"] + (["w_gate"] if act != "gelu" else [])
    for name in names:
        shape = (f, d) if name == "w_down" else (d, f)
        pj[name], pt[name] = _pair(shape, dtype, 0.2)
    xj, xt = _pair((2, 3, d), dtype)
    _close(tl.ffn_apply(pt, xt, act), jl.ffn_apply(pj, xj, act), dtype)


@pytest.mark.parametrize("frontend", [False, True])
def test_embed_tokens(frontend):
    cfg = get_smoke_config("phi4_mini_3_8b")
    if frontend:
        cfg = dataclasses.replace(cfg, frontend="vision", frontend_dim=24)
    ej, et = _pair((cfg.padded_vocab, cfg.d_model), "float32")
    pj, pt = {"tok_embed": ej}, {"tok_embed": et}
    fe = None
    if frontend:
        pj["frontend_proj"], pt["frontend_proj"] = _pair((24, cfg.d_model),
                                                         "float32")
        fe = RNG.standard_normal((2, 3, 24)).astype(np.float32)
    toks = RNG.integers(0, cfg.vocab_size, (2, 7))
    out = tl.embed_tokens(pt, torch.from_numpy(toks), port_config(cfg),
                          None if fe is None else torch.from_numpy(fe))
    exp = jl.embed_tokens(pj, jnp.asarray(toks), cfg,
                          None if fe is None else jnp.asarray(fe))
    _close(out, exp, "float32")


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_logits_masks_padded_vocab(tied, dtype):
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                              tie_embeddings=tied, dtype=dtype)
    V, d = cfg.padded_vocab, cfg.d_model
    assert V > cfg.vocab_size
    pj, pt = {}, {}
    pj["tok_embed"], pt["tok_embed"] = _pair((V, d), dtype, 0.1)
    if not tied:
        pj["lm_head"], pt["lm_head"] = _pair((d, V), dtype, 0.1)
    xj, xt = _pair((2, 3, d), dtype)
    out = tl.lm_logits(pt, xt, port_config(cfg))
    exp = jl.lm_logits(pj, xj, cfg)
    assert tuple(out.shape) == (2, 3, V)
    np.testing.assert_array_equal(f32(out)[..., cfg.vocab_size:],
                                  f32(exp)[..., cfg.vocab_size:])
    assert (f32(out)[..., cfg.vocab_size:] < -1e38).all()
    _close(out[..., :cfg.vocab_size], exp[..., :cfg.vocab_size], dtype)

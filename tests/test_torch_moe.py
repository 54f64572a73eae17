"""The port's MoE block against the JAX reference (tests/test_moe.py's
configurations), with the reference's weights converted to the port:
outputs, the aux loss, which (token, k) slots are dropped for lack of
capacity, the dense-residual branch and top-k ties."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_parity import f32, port_config, to_numpy  # noqa: E402

# float32: the same operations in another order (the dispatch and combine
# einsums are exact: one nonzero term each), 1e-5
F32_TOL = 1e-5


def _cfg(**moe_kw):
    """test_moe.py's block, with float32 experts (its default dtype gives
    bf16 experts, which it feeds float32 activations)."""
    return ModelConfig(d_model=32, act="swiglu", dtype="float32",
                       moe=MoEConfig(n_experts=4, top_k=2, d_expert=64,
                                     **moe_kw))


def _setup(cfg, S, seed=0):
    params = jmoe.moe_init(jax.random.PRNGKey(seed), cfg)
    x = np.random.default_rng(seed + 1).standard_normal(
        (1, S, cfg.d_model)).astype(np.float32)
    return params, convert.to_torch(to_numpy(params), device="cpu"), x


def _reference_slots(params, x, cfg):
    """(gate_idx, keep) of the reference's routing: jax.lax.top_k on its
    router probabilities, then the capacity rule run slot by slot in the
    k-major order the reference's cumsum takes (k = 0 for every token,
    then k = 1, ...)."""
    m = cfg.moe
    G = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(G, -1)) @ params["router"])
    idx = np.asarray(jax.lax.top_k(probs, m.top_k)[1])
    capacity = min(max(4, m.top_k, round(G * m.top_k * m.capacity_factor
                                         / m.n_experts)), G * m.top_k)
    taken = np.zeros(m.n_experts, int)
    keep = np.zeros_like(idx, bool)
    for k in range(m.top_k):
        for g in range(G):
            keep[g, k] = taken[idx[g, k]] < capacity
            taken[idx[g, k]] += 1
    return idx, keep


@pytest.mark.parametrize("cf,S", [(32.0, 8), (0.25, 64), (8.0, 8),
                                  (1.25, 16)])
def test_moe_matches_reference(cf, S):
    """tests/test_moe.py's capacity factors (32: lossless, 0.25: drops
    guaranteed, 8) and the stock 1.25: equal outputs and aux loss, and the
    same slots dropped."""
    cfg = _cfg(capacity_factor=cf)
    jp, tp, x = _setup(cfg, S)
    oj, aj = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    ot, at = tmoe.moe_apply(tp, torch.from_numpy(x), port_config(cfg))
    np.testing.assert_allclose(f32(ot), f32(oj), atol=F32_TOL, rtol=F32_TOL)
    assert at.dtype == torch.float32
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)

    idx, keep = _reference_slots(jp, x, cfg)
    xg = torch.from_numpy(x).reshape(1, S, -1)
    _, _, t_idx, _, t_keep, _ = tmoe.route(tp["router"], xg, port_config(cfg))
    np.testing.assert_array_equal(t_idx[0].numpy(), idx)
    np.testing.assert_array_equal(t_keep[0].numpy(), keep)
    # a token whose every slot is dropped gets exactly zero on both sides
    gone = ~keep.any(axis=1)
    if cf == 0.25:
        assert gone.any() and not keep.all()
    assert (f32(ot)[0, gone] == 0).all() and (f32(oj)[0, gone] == 0).all()


def test_moe_matches_reference_bf16():
    """bf16 activations and experts, float32 router: the reference tests'
    2e-2 (bf16 rounds at other points in the two frameworks)."""
    cfg = dataclasses.replace(_cfg(capacity_factor=8.0), dtype="bfloat16")
    jp, tp, x = _setup(cfg, 8)
    assert tp["router"].dtype == torch.float32
    assert tp["experts"]["w_up"].dtype == torch.bfloat16
    oj, _ = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), cfg)
    ot, _ = tmoe.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16),
                           port_config(cfg))
    assert ot.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(ot), f32(oj), atol=2e-2, rtol=2e-2)


def test_dense_residual_matches_reference():
    """The arctic-style parallel dense FFN (test_moe.py's
    test_dense_residual_branch_added)."""
    cfg = _cfg(capacity_factor=8.0)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dense_residual=True, d_dense_residual=64))
    jp, tp, x = _setup(cfg, 8)
    assert "dense" in tp
    oj, _ = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    ot, _ = tmoe.moe_apply(tp, torch.from_numpy(x), port_config(cfg))
    np.testing.assert_allclose(f32(ot), f32(oj), atol=F32_TOL, rtol=F32_TOL)


def test_uniform_router_ties_break_as_reference():
    """A zero router makes every expert tie: top-k takes the lowest
    indices, as jax.lax.top_k does, and the aux loss is its weight."""
    cfg = _cfg()
    jp, tp, x = _setup(cfg, 64)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    oj, aj = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    ot, at = tmoe.moe_apply(tp, torch.from_numpy(x), port_config(cfg))
    np.testing.assert_allclose(f32(ot), f32(oj), atol=F32_TOL, rtol=F32_TOL)
    assert float(at) == pytest.approx(float(aj), rel=1e-6)
    _, _, idx, _, _, _ = tmoe.route(tp["router"],
                                    torch.from_numpy(x).reshape(1, 64, -1),
                                    port_config(cfg))
    assert (idx[0] == torch.tensor([0, 1])).all()


def test_top_k_ties_take_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.1, 0.4], [0.2, 0.2, 0.5, 0.1]],
                     np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(probs), 2)
    vt, it = tmoe.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert it.tolist() == [[1, 2], [0, 1], [0, 3], [2, 0]]


def test_group_size_must_divide_the_tokens():
    """The reference asserts it; the port raises ValueError naming both."""
    cfg = _cfg()
    _, tp, _ = _setup(cfg, 8)
    assert tmoe.group_size_for(port_config(cfg)) == 256
    x = torch.zeros((1, 300, cfg.d_model))
    with pytest.raises(ValueError, match="300 tokens.*256"):
        tmoe.moe_apply(tp, x, port_config(cfg))


# --------------------------------------------- the expert products in K2
@pytest.mark.parametrize("cf,S", [(32.0, 8), (0.25, 64), (8.0, 8),
                                  (1.25, 16)])
def test_moe_kernel_path_matches_reference(cf, S):
    """use_kernel=True (the three expert products through ops.expert_gemm,
    its plain version on the CPU) at test_moe.py's capacity factors and the
    stock 1.25: the reference's outputs and aux loss, and the same slots
    dropped (a token whose every slot is dropped gets exactly zero)."""
    cfg = _cfg(capacity_factor=cf)
    jp, tp, x = _setup(cfg, S)
    oj, aj = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    ot, at = tmoe.moe_apply(tp, torch.from_numpy(x), port_config(cfg),
                            use_kernel=True)
    np.testing.assert_allclose(f32(ot), f32(oj), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    _, keep = _reference_slots(jp, x, cfg)
    gone = ~keep.any(axis=1)
    if cf == 0.25:
        assert gone.any()
    assert (f32(ot)[0, gone] == 0).all()


def test_moe_kernel_path_matches_reference_bf16():
    """bf16 activations and experts through ops.expert_gemm: the reference
    tests' 2e-2, as the einsum path."""
    cfg = dataclasses.replace(_cfg(capacity_factor=8.0), dtype="bfloat16")
    jp, tp, x = _setup(cfg, 8)
    oj, _ = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), cfg)
    ot, _ = tmoe.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16),
                           port_config(cfg), use_kernel=True)
    assert ot.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(ot), f32(oj), atol=2e-2, rtol=2e-2)


def _spy(monkeypatch):
    calls = []
    real = tmoe.ops.expert_gemm

    def spy(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    monkeypatch.setattr(tmoe.ops, "expert_gemm", spy)
    return calls


@pytest.mark.parametrize("act,per_layer", [("swiglu", 3), ("gelu", 2)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_expert_products_go_through_ops_only_with_use_kernel(
        monkeypatch, act, per_layer, use_kernel):
    """up, gate and down (up and down without a gate) each call
    ops.expert_gemm once, on [E, n·C, d_in]; use_kernel=False never does.
    The output is the reference's either way."""
    cfg = dataclasses.replace(_cfg(capacity_factor=1.25), act=act)
    jp, tp, x = _setup(cfg, 16)
    assert ("w_gate" in tp["experts"]) == (act == "swiglu")
    calls = _spy(monkeypatch)
    ot, _ = tmoe.moe_apply(tp, torch.from_numpy(x), port_config(cfg),
                           use_kernel=use_kernel)
    oj, _ = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    np.testing.assert_allclose(f32(ot), f32(oj), atol=F32_TOL, rtol=F32_TOL)
    E, d, dff = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    C = 10                       # round(16 * 2 * 1.25 / 4)
    want = [((E, C, d), (E, d, dff))] * (per_layer - 1) + [
        ((E, C, dff), (E, dff, d))]
    assert calls == (want if use_kernel else [])


@pytest.mark.parametrize("arch,moe_layers", [("granite_moe_1b_a400m", 2),
                                             ("jamba_v01_52b", 4)])
def test_prefill_sends_every_moe_layer_through_ops(monkeypatch, arch,
                                                   moe_layers):
    """A whole-model prefill with use_kernel makes 3 expert_gemm calls per
    MoE layer (granite's smoke config: every layer; jamba's: every other
    of 8), a decode step none."""
    from torch_parity import models

    _, _, pm, pp = models(arch, "float32")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, pm.cfg.vocab_size, (1, 9)))
    calls = _spy(monkeypatch)
    _, caches = pm.prefill(pp, toks, max_len=12, use_kernel=True)
    assert len(calls) == 3 * moe_layers
    pm.decode_step(pp, toks[:, :1], caches, 9)
    pm.prefill(pp, toks, max_len=12)
    assert len(calls) == 3 * moe_layers

"""The port's xLSTM blocks and model against the JAX reference, with the
reference's weights converted to the port and seeded numpy inputs."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, get_smoke_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.slstm_scan import slstm_kernel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from torch_parity import (TOL, f32, models, port_config,  # noqa: E402
                          reference_view, to_numpy)

ARCH = "xlstm_1_3b"
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# float32 pieces agree to rounding: both sides compute the same float32
# operations, in other orders
F32_TOL = 1e-5
# whole float32 models: the logits tolerance of the dense models (1e-4), or
# with the kernel path the bf16 one: that path rounds the sLSTM
# preactivations to bf16, and where the two frameworks' float32 sums land
# on either side of a rounding boundary a preactivation differs by one
# bf16 ulp (2^-8 relative), which reaches the logits
MODEL_TOL = {False: TOL["float32"], True: TOL["bfloat16"]}


def _arr(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _both(a, dtype="float32"):
    return jnp.asarray(a, JAX_DT[dtype]), torch.from_numpy(a).to(TORCH_DT[dtype])


def _close(t, j, tol):
    np.testing.assert_allclose(f32(t), f32(j), atol=tol, rtol=tol)


def _block_params(jp, pp, pos, g=0):
    jparams = jax.tree_util.tree_map(lambda a: a[g], jp["stack"][pos]["mixer"])
    tparams = {k: v[g] for k, v in pp["stack"][pos]["mixer"].items()}
    return jparams, tparams


def _qkv_gates(B, H, S, dh, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    q, k, v = (_both(_arr(rng, (B, H, S, dh)), dtype) for _ in range(3))
    ig = _both(_arr(rng, (B, H, S)))
    fg = _both(_arr(rng, (B, H, S), shift=2.0))
    return q, k, v, ig, fg


# ------------------------------------------------------------- conv / mLSTM
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(dtype, with_state):
    rng = np.random.default_rng(1)
    xj, xt = _both(_arr(rng, (2, 9, 12)), dtype)
    wj, wt = _both(_arr(rng, (4, 12), 0.5), dtype)
    bj, bt = _both(_arr(rng, (12,), 0.1), dtype)
    sj = st = None
    if with_state:
        sj, st = _both(_arr(rng, (2, 3, 12)), dtype)
    yj, nj = jssm.causal_conv1d(xj, wj, bj, sj)
    yt, nt = tssm.causal_conv1d(xt, wt, bt, st)
    # the same bf16 products and sums in the same order: equal
    np.testing.assert_array_equal(f32(yt), f32(yj))
    np.testing.assert_array_equal(f32(nt), f32(nj))


def test_mlstm_parallel_matches_reference():
    (qj, qt), (kj, kt), (vj, vt), (ij, it), (fj, ft) = _qkv_gates(
        2, 2, 32, 16, seed=2)
    _close(tx._mlstm_parallel(qt, kt, vt, it, ft, chunk=16),
           jx._mlstm_parallel(qj, kj, vj, ij, fj, chunk=16), F32_TOL)


@pytest.mark.parametrize("S,chunk", [(40, 16), (200, 128), (7, 128)])
def test_mlstm_parallel_ragged_last_chunk_matches_recurrent(S, chunk):
    """Lengths the reference's _mlstm_parallel cannot reshape (200 with its
    chunk of 128): the port's parallel form against its own recurrent form
    (test_kernels.py::test_mlstm_parallel_matches_recurrent's tolerance)."""
    B, H, dh = 2, 2, 16
    (_, q), (_, k), (_, v), (_, ig), (_, fg) = _qkv_gates(B, H, S, dh, seed=S)
    par = tx._mlstm_parallel(q, k, v, ig, fg, chunk=chunk)
    state = {"C": torch.zeros((B, H, dh, dh)), "n": torch.zeros((B, H, dh)),
             "m": torch.full((B, H), -1e30)}
    outs = []
    for t in range(S):
        sl = slice(t, t + 1)
        h, state = tx._mlstm_recurrent_step(
            q[:, :, sl], k[:, :, sl], v[:, :, sl], ig[:, :, sl],
            fg[:, :, sl], state)
        outs.append(h[:, :, 0])
    np.testing.assert_allclose(f32(par), f32(torch.stack(outs, dim=2)),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_recurrent_step_matches_reference(dtype):
    B, H, dh = 2, 2, 16
    (qj, qt), (kj, kt), (vj, vt), (ij, it), (fj, ft) = _qkv_gates(
        B, H, 1, dh, seed=3, dtype=dtype)
    rng = np.random.default_rng(4)
    state = {"C": _arr(rng, (B, H, dh, dh)),
             "n": _arr(rng, (B, H, dh)), "m": _arr(rng, (B, H))}
    hj, sj = jx._mlstm_recurrent_step(
        qj, kj, vj, ij, fj, {k: jnp.asarray(v) for k, v in state.items()})
    ht, st = tx._mlstm_recurrent_step(
        qt, kt, vt, it, ft, {k: torch.from_numpy(v) for k, v in state.items()})
    # the state is float32 on both sides; h is rounded to q's dtype
    _close(ht, hj, TOL[dtype] if dtype == "bfloat16" else F32_TOL)
    for key in ("C", "n", "m"):
        _close(st[key], sj[key], F32_TOL)


def test_mlstm_state_from_prefill_matches_reference():
    cfg = get_smoke_config(ARCH)
    (qj, qt), (kj, kt), (vj, vt), (ij, it), (fj, ft) = _qkv_gates(
        2, 2, 24, 16, seed=5)
    sj = jx._mlstm_state_from_prefill(qj, kj, vj, ij, fj, cfg)
    st = tx._mlstm_state_from_prefill(qt, kt, vt, it, ft)
    assert st.keys() == sj.keys()
    for key in sj:
        _close(st[key], sj[key], F32_TOL)


@pytest.fixture(scope="module")
def f32_models():
    return models(ARCH, "float32")


def _x(cfg, B, S, seed, dtype="float32"):
    return _both(_arr(np.random.default_rng(seed), (B, S, cfg.d_model)),
                 dtype)


@pytest.mark.parametrize("mode", ["no_state", "prefill", "decode"])
def test_mlstm_apply_matches_reference(f32_models, mode):
    """No state (training-style forward), a prefill from a fresh state, and
    one decode step from a random state."""
    jm, jp, _, pp = f32_models
    cfg = jm.cfg
    jparams, tparams = _block_params(jp, pp, "pos00")
    S = 1 if mode == "decode" else 12
    xj, xt = _x(cfg, 2, S, seed=6)
    sj = st = None
    if mode != "no_state":
        rng = np.random.default_rng(7)
        state = {k: (_arr(rng, v.shape) if mode == "decode" else np.asarray(v))
                 for k, v in jx.init_xlstm_state(cfg, 2, "mlstm").items()}
        state["m"] = np.abs(state["m"]) if mode == "decode" else state["m"]
        sj = {k: jnp.asarray(v) for k, v in state.items()}
        st = {k: torch.tensor(v) for k, v in state.items()}
    oj, nj = jx.mlstm_apply(jparams, xj, cfg, state=sj)
    ot, nt = tx.mlstm_apply(tparams, xt, cfg, state=st)
    _close(ot, oj, F32_TOL)
    assert (nt is None) == (nj is None)
    if nj is not None:
        assert nt.keys() == nj.keys()
        for key in nj:
            _close(nt[key], nj[key], F32_TOL)


# ------------------------------------------------------------------ sLSTM
@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply_matches_reference(f32_models, kernel, with_state):
    """use_kernel=False against use_pallas=False (in-loop float32 input
    projection); use_kernel=True against use_pallas=True (preactivations
    rounded to bf16, the Pallas kernel in interpret mode), from no state
    (m at -inf) and from a fresh engine state (m at -1e30)."""
    jm, jp, _, pp = f32_models
    cfg = jm.cfg
    jparams, tparams = _block_params(jp, pp, "pos01", g=1)
    xj, xt = _x(cfg, 2, 16, seed=8)
    sj = st = None
    if with_state:
        state = jx.init_xlstm_state(cfg, 2, "slstm")
        sj = state
        st = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    before = slstm_kernel.launches
    oj, nj = jx.slstm_apply(jparams, xj, cfg, state=sj,
                            return_state=True, use_pallas=kernel)
    ot, nt = tx.slstm_apply(tparams, xt, cfg, state=st, return_state=True,
                            use_kernel=kernel)
    assert slstm_kernel.launches == before   # CPU tensors: plain version
    _close(ot, oj, F32_TOL)
    for key in ("c", "n", "m", "h"):
        _close(nt[key], nj[key], F32_TOL)


def test_slstm_preact_rounds_to_bf16_like_reference(f32_models):
    jm, jp, _, pp = f32_models
    jparams, tparams = _block_params(jp, pp, "pos01")
    xj, xt = _x(jm.cfg, 2, 5, seed=9)
    pj = jx._slstm_preact(jparams, xj)
    pt = tx._slstm_preact(tparams, xt)
    assert pt.dtype == torch.bfloat16 and pt.shape == pj.shape
    # float32 sums in other orders, then one rounding: at most one bf16 ulp
    np.testing.assert_allclose(f32(pt), f32(pj), atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("kernel", [False, True])
def test_forward_matches_reference(f32_models, kernel):
    jm, jp, pm, pp = f32_models
    toks = np.random.default_rng(10).integers(0, jm.cfg.vocab_size, (2, 11))
    lj, _, _ = jm.forward(jp, jnp.asarray(toks), use_pallas=kernel)
    lt, caches = pm.forward(pp, torch.from_numpy(toks), use_kernel=kernel)
    assert caches is None
    assert tuple(lt.shape) == (2, 11, jm.cfg.padded_vocab)
    _close(lt, lj, MODEL_TOL[kernel])


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_bf16_matches_reference(seed):
    """bf16 logits. The two frameworks round bf16 at other points: XLA
    rounds every intermediate of silu and gelu to bf16 (gelu's constants
    too), torch computes each in float32 and rounds once. Over four xLSTM
    blocks that moves the logits on either side by more than the dense
    models' 2e-2, as far as bf16 moves the reference itself from its own
    float32 logits with the same (bf16-valued) weights. So the test
    measures that distance (the reference's bf16 error) and holds the
    port to its scale: its bf16 logits lie within twice the reference's
    bf16 error of the reference's bf16 logits and of the float32 logits,
    and pick the same token wherever the float32 top two logits are
    further apart than four times that error."""
    jm, jp, pm, pp = models(ARCH, "bfloat16", seed)
    cfg32 = dataclasses.replace(jm.cfg, dtype="float32")
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    toks = np.random.default_rng(seed).integers(0, jm.cfg.vocab_size, (2, 11))
    V = jm.cfg.vocab_size
    lj = f32(jm.forward(jp, jnp.asarray(toks))[0])[..., :V]
    l32 = f32(build_model(cfg32).forward(jp32, jnp.asarray(toks))[0])[..., :V]
    lt = f32(pm.forward(pp, torch.from_numpy(toks))[0])[..., :V]
    ref_err = np.abs(lj - l32).max()
    assert ref_err < 0.2, ref_err
    assert np.abs(lt - lj).max() <= 2 * ref_err
    assert np.abs(lt - l32).max() <= 2 * ref_err
    top2 = np.sort(l32, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 4 * ref_err
    assert (lt.argmax(-1) == l32.argmax(-1))[clear].all()


def test_blocks_bf16_match_reference():
    """One mLSTM and one sLSTM block in bf16 on the same inputs: within the
    bf16 tolerance of the reference tests (2e-2; the silu/gelu roundings
    above, once each)."""
    jm, jp, _, pp = models(ARCH, "bfloat16")
    cfg = jm.cfg
    xj, xt = _x(cfg, 2, 16, seed=11, dtype="bfloat16")
    for pos, fn_j, fn_t in (("pos00", jx.mlstm_apply, tx.mlstm_apply),
                            ("pos01", jx.slstm_apply, tx.slstm_apply)):
        jparams, tparams = _block_params(jp, pp, pos)
        oj, _ = fn_j(jparams, xj, cfg)
        ot, _ = fn_t(tparams, xt, cfg)
        scale = np.abs(f32(oj)).max()
        assert np.abs(f32(ot) - f32(oj)).max() <= 2e-2 * max(scale, 1.0), pos


@pytest.mark.parametrize("kernel", [False, True])
def test_prefill_matches_reference(f32_models, kernel):
    """Port prefill against the reference's (use_pallas alike): last
    logits and every recurrent state leaf."""
    jm, jp, pm, pp = f32_models
    toks = np.random.default_rng(12).integers(0, jm.cfg.vocab_size, (1, 13))
    lj, cj = jm.prefill(jp, jnp.asarray(toks), max_len=16, use_pallas=kernel)
    lt, ct = pm.prefill(pp, torch.from_numpy(toks), max_len=16,
                        use_kernel=kernel)
    _close(lt, lj, MODEL_TOL[kernel])
    assert ct.keys() == cj.keys()
    for name in cj:
        assert ct[name].keys() == cj[name].keys()
        for key in cj[name]:
            _close(ct[name][key], cj[name][key], MODEL_TOL[kernel])


def test_decode_step_from_reference_cache(f32_models):
    """Decode from the reference's own prefill state, converted."""
    jm, jp, pm, pp = f32_models
    toks = np.random.default_rng(13).integers(0, jm.cfg.vocab_size, (2, 10))
    _, cj = jm.prefill(jp, jnp.asarray(toks[:, :8]), max_len=12)
    ct = convert.to_torch(to_numpy(cj), device="cpu")
    for i in (8, 9):
        tok = toks[:, i:i + 1]
        lj, cj = jm.decode_step(jp, jnp.asarray(tok), cj, jnp.int32(i))
        lt, ct = pm.decode_step(pp, torch.from_numpy(tok), ct, i)
        _close(lt, lj, TOL["float32"])
        for name in cj:
            for key in cj[name]:
                _close(ct[name][key], cj[name][key], TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", [False, True])
def test_prefill_decode_matches_forward(kernel, dtype):
    """Prefill + decode reproduces full-forward logits: the xLSTM row of
    test_decode_consistency.py. In float32 its bound, 2e-2, holds with the
    kernel path too (whose prefill rounds the sLSTM preactivations to bf16
    where the forward does not). In bf16 the xLSTM logits reach |4|, where
    one bf16 ulp is 2^-5 > 2e-2, and torch's CPU matmuls round differently
    at different S (prefill 12 tokens, forward 16), so one flipped rounding
    upstream moves a logit by an ulp: there the bound is two ulps of the
    largest logit."""
    _, _, pm, pp = models(ARCH, dtype)
    B, S, P = 2, 16, 12
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, pm.cfg.vocab_size, (B, S)))
    full, _ = pm.forward(pp, toks)
    full = full[..., :pm.cfg.vocab_size].float()
    last, caches = pm.prefill(pp, toks[:, :P], max_len=S, use_kernel=kernel)
    V = pm.cfg.vocab_size
    errs = [float((last[:, :V].float() - full[:, P - 1]).abs().max())]
    for i in range(P, S):
        lg, caches = pm.decode_step(pp, toks[:, i:i + 1], caches, i)
        errs.append(float((lg[:, :V].float() - full[:, i]).abs().max()))
    bound = 2e-2
    if dtype == "bfloat16":
        top = float(full.abs().max())
        bound = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
    assert max(errs) < bound, (errs, bound)


def test_random_init_is_in_reference_layout():
    """Keys, shapes and dtypes of the reference, float32 leaves included."""
    jm, jp, pm, _ = models(ARCH, "bfloat16")
    ours = pm.init(3, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = ours
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), path
    n_ours = sum(1 for _ in convert.to_numpy(ours)["stack"]["pos01"]["mixer"])
    assert n_ours == len(jp["stack"]["pos01"]["mixer"])


def test_full_size_config_and_parameter_count():
    """The port's full config is the reference's, and the reference's
    shapes give the 2,926,053,568 parameters the config's docstring
    states."""
    from repro_torch.configs import get_config as port_get_config

    ref = get_config(ARCH)
    assert reference_view(port_get_config(ARCH), ref) == \
        dataclasses.asdict(ref)
    specs = build_model(ref).param_specs()
    leaves = jax.tree_util.tree_leaves(specs)
    assert sum(int(np.prod(s.shape)) for s in leaves) == 2_926_053_568
    assert sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for s in leaves) == 6_861_103_872
    cfg = port_config(ref)
    assert (cfg.n_groups, cfg.resolved_scan_period) == (24, 2)
    assert [cfg.layer_kind(p) for p in range(2)] == ["mlstm", "slstm"]
    assert tx.slstm_dims(cfg) == (2048, 512)
    assert tx.mlstm_dims(cfg) == (4096, 1024)

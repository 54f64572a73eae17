"""The port's Mamba mixer and Jamba (Mamba + attention + MoE) against the
JAX reference, with the reference's weights converted to the port and
seeded numpy inputs: the chunked selective scan, ``ssm_apply`` with and
without a state, the kernel path (the scan's plain version on the CPU)
against the reference's ``use_pallas=True``, decoding from the reference's
own caches, and prefill + decode against forward."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_kernel  # noqa: E402
from repro_torch.models import build_model as build_port_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from torch_parity import TOL, f32, models, port_config, to_numpy  # noqa: E402

ARCH = "jamba_v01_52b"
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# float32 pieces: the same float32 operations summed in other orders (the
# scans combine their pairs along other trees)
F32_TOL = 1e-5
# the float32 state of a bf16 model: silu rounds at other points in the two
# frameworks, so u and B differ by a bf16 ulp here and there, and h sums
# those differences over the steps: the bf16 tolerance (the reference
# kernel test holds a bf16 run's h to 1e-2 against its oracle)
H_TOL = {"float32": F32_TOL, "bfloat16": TOL["bfloat16"]}


def _close(t, j, tol):
    np.testing.assert_allclose(f32(t), f32(j), atol=tol, rtol=tol)


def _scan_inputs(Bb, S, d, N, seed):
    """As test_kernels.py::test_chunked_selective_scan_matches_sequential
    draws them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bb, S, d)).astype(np.float32),
            rng.uniform(1e-3, 0.1, (Bb, S, d)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (d, N)).astype(np.float32),
            rng.standard_normal((Bb, S, N)).astype(np.float32),
            rng.standard_normal((Bb, S, N)).astype(np.float32),
            rng.standard_normal((d,)).astype(np.float32),
            rng.standard_normal((Bb, d, N)).astype(np.float32))


# ------------------------------------------------------------ selective scan
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_matches_reference(with_h0):
    """The reference's chunked associative scan at chunk 32 (its test's
    setting) and the port's log-depth scan, from zero or a given state."""
    *arrs, h0 = _scan_inputs(2, 128, 64, 8, seed=1)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    yj, hj = jssm.selective_scan(*map(jnp.asarray, arrs), h0=jh0, chunk=32)
    yt, ht = tssm.selective_scan(*map(torch.from_numpy, arrs), h0=th0,
                                 chunk=32)
    _close(yt, yj, 1e-4)
    _close(ht, hj, 1e-4)


@pytest.mark.parametrize("S,chunk", [(100, 64), (37, 16), (1, 64)])
def test_selective_scan_any_length(S, chunk):
    """Lengths the reference's scan refuses (S % chunk != 0 for S > chunk):
    the port takes a shorter last chunk; the reference's sequential oracle
    is the yardstick."""
    *arrs, h0 = _scan_inputs(2, S, 48, 16, seed=S)
    yj, hj = jref.ssm_scan_ref(*map(jnp.asarray, arrs), h0=jnp.asarray(h0))
    yt, ht = tssm.selective_scan(*map(torch.from_numpy, arrs),
                                 h0=torch.from_numpy(h0), chunk=chunk)
    _close(yt, yj, 1e-4)
    _close(ht, hj, 1e-4)


# ---------------------------------------------------------------- ssm_apply
def _mixer(jp, pp, pos="pos00"):
    jparams = jax.tree_util.tree_map(lambda a: a[0], jp["stack"][pos]["mixer"])
    tparams = {k: v[0] for k, v in pp["stack"][pos]["mixer"].items()}
    return jparams, tparams


def _x(cfg, B, S, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(a, JAX_DT[dtype]), torch.from_numpy(a).to(
        TORCH_DT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 9])
def test_ssm_apply_matches_reference(dtype, S):
    """Without a state, and with one (S = 1 is a decode step, a scan of
    one step on both sides). float32 at 1e-5; bf16 at the reference
    tests' 2e-2."""
    jm, jp, pm, pp = models(ARCH, dtype)
    cfg = jm.cfg
    jparams, tparams = _mixer(jp, pp)
    xj, xt = _x(cfg, 2, S, seed=S, dtype=dtype)
    tol = F32_TOL if dtype == "float32" else TOL["bfloat16"]

    oj, _ = jssm.ssm_apply(jparams, xj, cfg)
    ot, st = tssm.ssm_apply(tparams, xt, pm.cfg)
    assert st is None and ot.dtype == TORCH_DT[dtype]
    _close(ot, oj, tol)

    rng = np.random.default_rng(S + 1)
    state = jssm.init_ssm_state(cfg, 2)
    state = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
             for k, v in state.items()}
    oj, sj = jssm.ssm_apply(jparams, xj, cfg, state=state)
    ot, st = tssm.ssm_apply(tparams, xt, pm.cfg,
                            state=convert.to_torch(to_numpy(state), device="cpu"))
    _close(ot, oj, tol)
    assert st["conv"].dtype == TORCH_DT[dtype]
    assert st["h"].dtype == torch.float32
    _close(st["conv"], sj["conv"], 0.0)
    _close(st["h"], sj["h"], H_TOL[dtype])


def test_dt_is_float32_in_a_bf16_model():
    """dt_bias is a float32 leaf, so dt is float32 in both frameworks while
    u, B and C stay bf16: the scan sees the model's mixed dtypes."""
    _, jp, pm, pp = models(ARCH, "bfloat16")
    _, tparams = _mixer(jp, pp)
    for leaf in ("a_log", "dt_bias", "ssm_d"):
        assert tparams[leaf].dtype == torch.float32, leaf
    seen = {}

    def spy(u, dt, A, B, C, D, h0=None):
        seen.update(u=u.dtype, dt=dt.dtype, B=B.dtype, C=C.dtype)
        return real(u, dt, A, B, C, D, h0=h0)

    real = tssm.ops.ssm_scan
    tssm.ops.ssm_scan = spy
    try:
        tssm.ssm_apply(tparams, torch.zeros((1, 5, pm.cfg.d_model),
                                            dtype=torch.bfloat16),
                       pm.cfg, use_kernel=True)
    finally:
        tssm.ops.ssm_scan = real
    assert seen == {"u": torch.bfloat16, "dt": torch.float32,
                    "B": torch.bfloat16, "C": torch.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_kernel_path_matches_reference_pallas(dtype):
    """use_kernel (ops.ssm_scan: its plain version on CPU tensors) against
    the reference's use_pallas=True (the Pallas kernel in interpret mode)."""
    jm, jp, pm, pp = models(ARCH, dtype)
    jparams, tparams = _mixer(jp, pp)
    xj, xt = _x(jm.cfg, 2, 12, seed=4, dtype=dtype)
    before = ssm_kernel.launches
    oj, sj = jssm.ssm_apply(jparams, xj, jm.cfg, return_state=True,
                            use_pallas=True)
    ot, st = tssm.ssm_apply(tparams, xt, pm.cfg, return_state=True,
                            use_kernel=True)
    assert ssm_kernel.launches == before     # CPU: the plain version
    tol = F32_TOL if dtype == "float32" else TOL["bfloat16"]
    _close(ot, oj, tol)
    _close(st["h"], sj["h"], H_TOL[dtype])


# ------------------------------------------------------------- whole model
@pytest.mark.parametrize("kernel", [False, True])
def test_prefill_matches_reference(kernel):
    """Prefill logits and every cache leaf (attention k/v, Mamba conv and
    h) against the reference with use_pallas False and True, float32."""
    jm, jp, pm, pp = models(ARCH, "float32")
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab_size, (1, 13))
    lt, ct = pm.prefill(pp, torch.from_numpy(toks), max_len=16,
                        use_kernel=kernel)
    assert set(ct["pos00"]) == {"conv", "h"}
    assert set(ct["pos04"]) == {"k", "v"}
    for use_pallas in (False, True):
        lj, cj = jm.prefill(jp, jnp.asarray(toks), max_len=16,
                            use_pallas=use_pallas)
        _close(lt, lj, TOL["float32"])
        for name in cj:
            for key in cj[name]:
                _close(ct[name][key], cj[name][key], TOL["float32"])


def test_decode_step_from_reference_cache():
    """Decode from the reference's own prefill cache, converted, in float32
    (in bf16 the whole model drifts from either side's float32 result by
    more than 2e-2: test_torch_model.py holds it to that drift); lossless
    routing (capacity factor 16)."""
    dtype = "float32"
    jm, jp, _, pp = models(ARCH, dtype)
    cfg = dataclasses.replace(jm.cfg, moe=dataclasses.replace(
        jm.cfg.moe, capacity_factor=16.0))
    from repro.models import build_model
    jm, pm = build_model(cfg), build_port_model(port_config(cfg))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9))
    _, cj = jm.prefill(jp, jnp.asarray(toks[:, :8]), max_len=12)
    ct = convert.to_torch(to_numpy(cj), device="cpu")
    tok = toks[:, 8:9]
    for i in range(8, 10):
        lj, cj = jm.decode_step(jp, jnp.asarray(tok), cj, jnp.int32(i))
        lt, ct = pm.decode_step(pp, torch.from_numpy(tok), ct, i)
        _close(lt, lj, TOL[dtype])
        tok = np.argmax(f32(lj), -1)[:, None]
    for name in cj:
        for key in cj[name]:
            _close(ct[name][key], cj[name][key], TOL[dtype])


@pytest.mark.parametrize("arch,dtype,kernel", [
    (ARCH, "bfloat16", False), (ARCH, "float32", True),
    ("granite_moe_1b_a400m", "bfloat16", False),
    ("granite_moe_1b_a400m", "float32", True)])
def test_prefill_decode_matches_forward(arch, dtype, kernel):
    """Prefill + decode reproduces full-forward logits: the reference's
    test_prefill_decode_matches_forward, MoE rows at capacity factor 16
    (routing is lossless, so grouping cannot change which slots drop), and
    its 2e-2. The kernel path rounds y to the model dtype at the same point
    as the plain path; it runs in float32 here."""
    _, _, pm, pp = models(arch, dtype)
    cfg = dataclasses.replace(pm.cfg, moe=dataclasses.replace(
        pm.cfg.moe, capacity_factor=16.0))
    pm = build_port_model(cfg)
    B, S, P = 2, 16, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    full, _ = pm.forward(pp, toks)
    last, caches = pm.prefill(pp, toks[:, :P], max_len=S, use_kernel=kernel)
    errs = [float((last.float() - full[:, P - 1].float()).abs().max())]
    for i in range(P, S):
        lg, caches = pm.decode_step(pp, toks[:, i:i + 1], caches, i)
        errs.append(float((lg.float() - full[:, i].float()).abs().max()))
    assert max(errs) < 2e-2, (arch, errs)


def test_jamba_layer_layout():
    """Jamba's period of 8: attention at position 4, Mamba elsewhere, MoE
    on odd positions (the 16-layer cut served on the card is two such
    groups); each leaf in the reference's layout and dtype."""
    jm, jp, pm, pp = models(ARCH, "bfloat16")
    cfg = pm.cfg
    assert cfg.resolved_scan_period == 8
    assert [cfg.layer_kind(i) for i in range(8)] == ["ssm"] * 4 + ["attn"] \
        + ["ssm"] * 3
    stack = pp["stack"]
    for p in range(8):
        block = stack[f"pos{p:02d}"]
        assert ("moe" in block) == (p % 2 == 1)
        assert ("ffn" in block) == (p % 2 == 0)
    assert stack["pos01"]["moe"]["router"].dtype == torch.float32
    a, b = pm.init(3, device="cpu"), pm.init(3, device="cpu")
    ja = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in ja:
        t = a
        for k in (p.key for p in path):
            t = t[k]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), path
    moe_up = [tree["stack"]["pos01"]["moe"]["experts"]["w_up"]
              for tree in (a, b)]
    assert torch.equal(*moe_up)
    assert torch.equal(a["stack"]["pos00"]["mixer"]["a_log"][0, 0],
                       torch.log(torch.arange(1.0, cfg.ssm.d_state + 1)))

"""The port's model (forward, prefill, decode) against the JAX reference,
with the reference's weights converted to the port."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro_torch import convert, resolve_device  # noqa: E402
from repro_torch.models import build_model as build_port_model  # noqa: E402
from torch_parity import TOL, f32, models, port_config, to_numpy  # noqa: E402

ARCHS = ["phi4_mini_3_8b", "gemma_2b"]
DTYPES = ["float32", "bfloat16"]
# bf16 cache entries are K/V rounded to bf16 after upstream layers that
# round at other points than the reference: a few bf16 ulps (2^-8
# relative) apart at |x| ~ 2, so 5e-2 absolute; float32 as the logits
CACHE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(t, j, dtype):
    np.testing.assert_allclose(f32(t), f32(j), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _close_caches(ct, cj, dtype):
    assert ct.keys() == cj.keys()
    for name in cj:
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                f32(ct[name][kv]), f32(cj[name][kv]), atol=CACHE_TOL[dtype],
                rtol=TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(arch, dtype):
    jm, jp, pm, pp = models(arch, dtype)
    toks = _tokens(jm.cfg, (2, 11), 1)
    lj, _, _ = jm.forward(jp, jnp.asarray(toks))
    lt, caches = pm.forward(pp, torch.from_numpy(toks))
    assert caches is None
    assert tuple(lt.shape) == (2, 11, jm.cfg.padded_vocab)
    _close(lt, lj, dtype)


@pytest.mark.parametrize("arch", ["chatglm3_6b", "codeqwen15_7b",
                                  "internvl2_2b", "musicgen_large"])
def test_forward_other_dense_archs(arch):
    """The other dense families (partial RoPE, vision and audio frontend
    stubs, plain GELU FFN), configs built from the reference's."""
    jm, jp, pm, pp = models(arch, "float32")
    cfg = jm.cfg
    toks = _tokens(cfg, (2, 12), 5)
    fe = None
    if cfg.frontend != "none":
        fe = np.random.default_rng(6).standard_normal(
            (2, 4, cfg.frontend_dim)).astype(np.float32)
    lj, _, _ = jm.forward(jp, jnp.asarray(toks),
                          None if fe is None else jnp.asarray(fe))
    lt, _ = pm.forward(pp, torch.from_numpy(toks),
                       None if fe is None else torch.from_numpy(fe))
    _close(lt, lj, "float32")


@pytest.mark.parametrize("arch", ["chatglm3_6b", "codeqwen15_7b",
                                  "internvl2_2b", "musicgen_large"])
def test_forward_other_dense_archs_bf16(arch):
    """bf16 logits of the other dense families. Their logits reach |3-4|,
    where a bf16 ulp is 0.016-0.031, and XLA and torch round at other
    points (ROADMAP Queue 3: port against reference 0.029-0.039), so the
    port is held within twice the reference's own bf16 distance from its
    float32 logits on the same bf16-valued weights, as the xLSTM and MoE
    rows are, against both."""
    from repro.models import build_model

    jm, jp, pm, pp = models(arch, "bfloat16")
    cfg = jm.cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    toks = _tokens(cfg, (2, 12), 5)
    fe = None
    if cfg.frontend != "none":
        fe = np.random.default_rng(6).standard_normal(
            (2, 4, cfg.frontend_dim)).astype(np.float32)
    V = cfg.vocab_size
    jfe = None if fe is None else jnp.asarray(fe)
    lj = f32(jm.forward(jp, jnp.asarray(toks), jfe)[0])[..., :V]
    l32 = f32(build_model(cfg32).forward(jp32, jnp.asarray(toks), jfe)[0]
              )[..., :V]
    lt = f32(pm.forward(pp, torch.from_numpy(toks),
                        None if fe is None else torch.from_numpy(fe))[0]
             )[..., :V]
    ref_err = max(np.abs(lj - l32).max(), TOL["bfloat16"])
    assert ref_err < 0.2, ref_err
    assert np.abs(lt - lj).max() <= 2 * ref_err
    assert np.abs(lt - l32).max() <= 2 * ref_err


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", [False, True])
def test_prefill_matches_reference(arch, dtype, kernel):
    """Port prefill (plain attention, or the kernel path: its plain version
    on the CPU) against the reference with use_pallas False and True."""
    jm, jp, pm, pp = models(arch, dtype)
    toks = _tokens(jm.cfg, (1, 13), 2)
    lt, ct = pm.prefill(pp, torch.from_numpy(toks), max_len=16,
                        use_kernel=kernel)
    for use_pallas in (False, True):
        lj, cj = jm.prefill(jp, jnp.asarray(toks), max_len=16,
                            use_pallas=use_pallas)
        _close(lt, lj, dtype)
        _close_caches(ct, cj, dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_from_reference_cache(arch, dtype):
    """Decode from the reference's own prefill cache, converted."""
    jm, jp, pm, pp = models(arch, dtype)
    toks = _tokens(jm.cfg, (2, 9), 3)
    _, cj = jm.prefill(jp, jnp.asarray(toks[:, :8]), max_len=12)
    ct = convert.to_torch(to_numpy(cj), device="cpu")
    for i in range(8, 10):
        tok = toks[:, 8:9] if i == 8 else np.argmax(f32(lt), -1)[:, None]
        lj, cj = jm.decode_step(jp, jnp.asarray(tok), cj, jnp.int32(i))
        lt, ct = pm.decode_step(pp, torch.from_numpy(tok), ct, i)
        _close(lt, lj, dtype)
        _close_caches(ct, cj, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_per_lane_cache_index_decode(dtype):
    """A [B] cache_index (continuous batching) equals per-lane scalar decode,
    and equals the reference's per-lane decode."""
    jm, jp, pm, pp = models("phi4_mini_3_8b", dtype)
    toks = _tokens(jm.cfg, (2, 12), 4)
    tt = torch.from_numpy(toks)
    _, ca = pm.prefill(pp, tt[:1, :8], max_len=16)
    _, cb = pm.prefill(pp, tt[1:, :5], max_len=16)
    merged = {n: {kv: torch.cat([ca[n][kv], cb[n][kv]], dim=1)
                  for kv in ca[n]} for n in ca}
    tok = torch.stack([tt[0, 8:9], tt[1, 5:6]])
    lg_arr, _ = pm.decode_step(pp, tok, merged, torch.tensor([8, 5]))
    lg_a, _ = pm.decode_step(pp, tt[:1, 8:9], ca, 8)
    lg_b, _ = pm.decode_step(pp, tt[1:, 5:6], cb, 5)
    _close(lg_arr[0], lg_a[0], dtype)
    _close(lg_arr[1], lg_b[0], dtype)

    _, ja = jm.prefill(jp, jnp.asarray(toks[:1, :8]), max_len=16)
    _, jb = jm.prefill(jp, jnp.asarray(toks[1:, :5]), max_len=16)
    jmerged = jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b], axis=1), ja, jb)
    lj, _ = jm.decode_step(jp, jnp.asarray(tok.numpy()), jmerged,
                           jnp.asarray([8, 5], jnp.int32))
    _close(lg_arr, lj, dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kernel", [False, True])
def test_prefill_decode_matches_forward(arch, kernel):
    """Prefill + decode reproduces full-forward logits (the reference's
    test_prefill_decode_matches_forward, dense rows)."""
    _, _, pm, pp = models(arch, "bfloat16")
    B, S, P = 2, 16, 12
    toks = torch.from_numpy(_tokens(pm.cfg, (B, S), 1))
    full, _ = pm.forward(pp, toks)
    last, caches = pm.prefill(pp, toks[:, :P], max_len=S, use_kernel=kernel)
    errs = [float((last.float() - full[:, P - 1].float()).abs().max())]
    for i in range(P, S):
        lg, caches = pm.decode_step(pp, toks[:, i:i + 1], caches, i)
        errs.append(float((lg.float() - full[:, i].float()).abs().max()))
    assert max(errs) < 2e-2, (arch, errs)


def _consistency_errors(prefill, decode, full, toks, P):
    """Largest |prefill/decode logits - forward logits| of each position."""
    last, caches = prefill(toks[:, :P])
    errs = [np.abs(f32(last) - full[:, P - 1]).max()]
    for i in range(P, toks.shape[1]):
        lg, caches = decode(toks[:, i:i + 1], caches, i)
        errs.append(np.abs(f32(lg) - full[:, i]).max())
    return errs


@pytest.mark.parametrize("arch", ["chatglm3_6b", "codeqwen15_7b",
                                  "musicgen_large"])
@pytest.mark.parametrize("kernel", [False, True])
def test_prefill_decode_matches_forward_other_dense(arch, kernel):
    """The other dense rows of the reference's
    tests/test_decode_consistency.py: bf16, 2e-2 on the plain path. On the
    kernel path (the kernel's plain version on the CPU, which rounds its
    probabilities to bf16 as the kernel does) the reference itself misses
    2e-2 with use_pallas=True at these logits of |3-4| (0.033, 0.043 and
    0.021), so the port is held within twice the reference's own error."""
    jm, jp, pm, pp = models(arch, "bfloat16")
    B, S, P = 2, 16, 12
    toks = _tokens(pm.cfg, (B, S), 1)
    tt = torch.from_numpy(toks)
    errs = _consistency_errors(
        lambda t: pm.prefill(pp, torch.from_numpy(t), max_len=S,
                             use_kernel=kernel),
        lambda t, c, i: pm.decode_step(pp, torch.from_numpy(t), c, i),
        f32(pm.forward(pp, tt)[0]), toks, P)
    bound = 2e-2
    if kernel:
        ref_errs = _consistency_errors(
            lambda t: jm.prefill(jp, jnp.asarray(t), max_len=S,
                                 use_pallas=True),
            lambda t, c, i: jm.decode_step(jp, jnp.asarray(t), c,
                                           jnp.int32(i)),
            f32(jm.forward(jp, jnp.asarray(toks))[0]), toks, P)
        bound = 2 * max(max(ref_errs), bound)
    assert max(errs) < bound, (arch, errs, bound)


def test_random_init_is_seeded_and_in_reference_layout():
    jm, jp, pm, _ = models("phi4_mini_3_8b", "bfloat16")
    a, b = pm.init(5, device="cpu"), pm.init(5, device="cpu")
    c = pm.init(6, device="cpu")
    ja = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in ja:
        keys = [p.key for p in path]
        t = a
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape, keys
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), keys
    wq = [tree["stack"]["pos00"]["mixer"]["wq"] for tree in (a, b, c)]
    assert torch.equal(wq[0], wq[1])
    assert not torch.equal(wq[0], wq[2])


MOE_ARCHS = ["jamba_v01_52b", "arctic_480b", "granite_moe_1b_a400m"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_and_hybrid_forward_match_reference(arch):
    """Jamba (Mamba + attention + MoE), arctic (MoE with a dense residual)
    and granite (top-8 MoE) in float32 at the stock capacity factor, where
    slots are dropped: the same logits."""
    jm, jp, pm, pp = models(arch, "float32")
    toks = _tokens(jm.cfg, (2, 11), 1)
    lj, _, _ = jm.forward(jp, jnp.asarray(toks))
    lt, _ = pm.forward(pp, torch.from_numpy(toks))
    _close(lt, lj, "float32")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_and_hybrid_blocks_bf16_match_reference(arch):
    """bf16, every block position of the first group on the reference's own
    input to it, at the stock capacity factor: the reference tests' 2e-2,
    plus one bf16 ulp of the block's largest output. silu rounds at other
    points in the two frameworks; in a Mamba block it feeds dt, B, C and
    the gate, and the one-ulp differences of y summed by out_proj reach
    the residual stream, which bf16 rounds at its own scale (2 to 8 here,
    an ulp of 0.016 to 0.031)."""
    from repro.models.layers import embed_tokens
    from repro.models.transformer import block_apply
    from repro_torch.models import transformer as ttr

    jm, jp, pm, pp = models(arch, "bfloat16")
    cfg = jm.cfg
    toks = _tokens(cfg, (2, 11), 1)
    x = embed_tokens(jp["embed"], jnp.asarray(toks), cfg)
    pos_j = jnp.arange(11, dtype=jnp.int32)[None]
    pos_t = torch.arange(11, dtype=torch.int32)[None]
    for p in range(cfg.resolved_scan_period):
        name = f"pos{p:02d}"
        jpar = jax.tree_util.tree_map(lambda a: a[0], jp["stack"][name])
        y, _, _ = block_apply(jpar, x, pos_j, cfg, p)
        yt, _ = ttr.block_apply(ttr._index(pp["stack"][name], 0),
                             torch.from_numpy(f32(x)).to(torch.bfloat16),
                             pos_t, pm.cfg, p)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(f32(y)).max())) - 7)
        np.testing.assert_allclose(f32(yt), f32(y), rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"] + ulp)
        x = y


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_and_hybrid_forward_bf16_matches_reference(arch):
    """bf16 logits of the whole model. A bf16 ulp of difference upstream
    can move a token across a routing boundary (top-k or capacity), after
    which the two runs compute different functions; so this runs with
    lossless routing (capacity factor 16, as the reference's decode
    consistency test does for MoE). Even so, over 2 to 8 blocks bf16 moves
    the reference from its own float32 logits (same bf16-valued weights)
    by more than 2e-2 (up to ~0.3 for jamba), so, as for xLSTM, the port is
    held within twice that distance of the reference's bf16 logits and of
    the float32 logits, and must pick the same token wherever the float32
    top two logits are further apart than four times it."""
    from repro.models import build_model

    jm, jp, pm, pp = models(arch, "bfloat16")
    cfg = dataclasses.replace(jm.cfg, moe=dataclasses.replace(
        jm.cfg.moe, capacity_factor=16.0))
    jm, pm = build_model(cfg), build_port_model(port_config(cfg))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    toks = _tokens(cfg, (2, 11), 1)
    V = cfg.vocab_size
    lj = f32(jm.forward(jp, jnp.asarray(toks))[0])[..., :V]
    l32 = f32(build_model(cfg32).forward(jp32, jnp.asarray(toks))[0])[..., :V]
    lt = f32(pm.forward(pp, torch.from_numpy(toks))[0])[..., :V]
    ref_err = max(np.abs(lj - l32).max(), TOL["bfloat16"])
    assert ref_err < 0.5, ref_err
    assert np.abs(lt - lj).max() <= 2 * ref_err
    assert np.abs(lt - l32).max() <= 2 * ref_err
    top2 = np.sort(l32, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 4 * ref_err
    assert (lt.argmax(-1) == l32.argmax(-1))[clear].all()


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "jamba_v01_52b"])
@pytest.mark.parametrize("kernel", [False, True])
def test_moe_prefill_matches_reference(arch, kernel):
    """MoE prefill in float32 at the stock capacity factor, with the expert
    products in ops.expert_gemm (kernel: its plain version on the CPU, with
    flash attention's and the selective scan's) or the einsums: logits and
    every cache leaf against the reference with use_pallas False and
    True."""
    jm, jp, pm, pp = models(arch, "float32")
    toks = _tokens(jm.cfg, (1, 13), 2)
    lt, ct = pm.prefill(pp, torch.from_numpy(toks), max_len=16,
                        use_kernel=kernel)
    for use_pallas in (False, True):
        lj, cj = jm.prefill(jp, jnp.asarray(toks), max_len=16,
                            use_pallas=use_pallas)
        _close(lt, lj, "float32")
        assert ct.keys() == cj.keys()
        for name in cj:
            for key in cj[name]:
                np.testing.assert_allclose(
                    f32(ct[name][key]), f32(cj[name][key]),
                    atol=CACHE_TOL["float32"], rtol=TOL["float32"])


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = port_config(get_smoke_config("gemma_2b"))
    with pytest.raises(RuntimeError, match="cuda"):
        build_port_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")

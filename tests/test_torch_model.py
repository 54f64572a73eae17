"""The port's model (forward, prefill, decode) against the JAX reference,
with the reference's weights converted to the port."""
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
    ct = convert.to_torch(to_numpy(cj))
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


@pytest.mark.parametrize("arch", ["jamba_v01_52b", "arctic_480b",
                                  "granite_moe_1b_a400m"])
def test_unported_layers_raise_with_roadmap_item(arch):
    cfg = port_config(get_smoke_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_port_model(cfg).init(0, device="cpu")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = port_config(get_smoke_config("gemma_2b"))
    with pytest.raises(RuntimeError, match="cuda"):
        build_port_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")

"""Flash attention of the port: the plain version against the JAX Pallas
kernel (interpret mode on the CPU) and its oracle. The CUDA kernel against
the plain version on the card: test_torch_flash_attention_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_ref, flash_kernel)
from repro_torch.models import attention as tattn  # noqa: E402
from torch_parity import f32, port_config  # noqa: E402

RNG = np.random.default_rng(42)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(B, S, Hq, Hkv, hd, dtype):
    arrs = [RNG.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    return ([jnp.asarray(a, JAX_DT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs])


def _tol(dtype):
    return (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
            else dict(atol=2e-4, rtol=2e-4))


# test_kernels.py::test_flash_attention_matches_ref's grid
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,bq,bk", [
    (1, 128, 2, 2, 64, 64, 64),      # MHA
    (2, 256, 4, 2, 64, 128, 128),    # GQA
    (1, 128, 4, 1, 128, 64, 64),     # MQA
    (1, 256, 2, 2, 256, 128, 64),    # big head_dim (gemma), uneven blocks
])
def test_plain_matches_pallas_and_oracle(dtype, B, S, Hq, Hkv, hd, bq, bk):
    (qj, kj, vj), (qt, kt, vt) = _qkv(B, S, Hq, Hkv, hd, dtype)
    out = ops.flash_attention(qt, kt, vt)
    assert out.dtype == qt.dtype and tuple(out.shape) == (B, S, Hq, hd)
    pallas = jops.flash_attention(qj, kj, vj, block_q=bq, block_k=bk)
    oracle = jref.flash_attention_ref(qj, kj, vj)
    np.testing.assert_allclose(f32(out), f32(pallas), **_tol(dtype))
    np.testing.assert_allclose(f32(out), f32(oracle), **_tol(dtype))


def test_plain_matches_pallas_sliding_window():
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 256, 2, 2, 64, "float32")
    out = ops.flash_attention(qt, kt, vt, window=64)
    np.testing.assert_allclose(
        f32(out), f32(jops.flash_attention(qj, kj, vj, window=64,
                                           block_q=64, block_k=64)),
        atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(
        f32(out), f32(jref.flash_attention_ref(qj, kj, vj, window=64)),
        atol=2e-4, rtol=2e-4)


def test_plain_matches_pallas_softcap():
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 128, 2, 2, 64, "float32")
    out = ops.flash_attention(qt, kt, vt, softcap=20.0)
    np.testing.assert_allclose(
        f32(out), f32(jops.flash_attention(qj, kj, vj, softcap=20.0,
                                           block_q=64, block_k=64)),
        atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(
        f32(out), f32(jref.flash_attention_ref(qj, kj, vj, softcap=20.0)),
        atol=2e-4, rtol=2e-4)


# ragged lengths: the Pallas kernel asserts S % block_q == 0, the port's
# kernel masks, so these hold against the oracle only
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window,softcap,causal", [
    (1, 37, 4, 2, 16, 0, 0.0, True),
    (2, 100, 4, 1, 32, 0, 0.0, True),
    (1, 77, 2, 2, 64, 30, 0.0, True),
    (1, 53, 3, 1, 128, 0, 20.0, True),
    (1, 45, 4, 2, 16, 0, 0.0, False),
])
def test_plain_ragged_matches_oracle(dtype, B, S, Hq, Hkv, hd, window,
                                     softcap, causal):
    (qj, kj, vj), (qt, kt, vt) = _qkv(B, S, Hq, Hkv, hd, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(
        f32(ops.flash_attention(qt, kt, vt, **kw)),
        f32(jref.flash_attention_ref(qj, kj, vj, **kw)), **_tol(dtype))


def test_cpu_dispatch_uses_plain_version_and_counts_nothing():
    _, (q, k, v) = _qkv(1, 16, 2, 1, 16, "float32")
    before = flash_kernel.launches
    out = ops.flash_attention(q, k, v)
    assert flash_kernel.launches == before
    torch.testing.assert_close(out, flash_attention_ref(q, k, v), rtol=0,
                               atol=0)


def test_kernel_refuses_cpu_tensors():
    _, (q, k, v) = _qkv(1, 16, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_kernel(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_attention_matches_reference(dtype):
    jcfg = JaxModelConfig(n_heads=4, n_kv_heads=2, head_dim=32)
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 24, 4, 2, 32, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        f32(tattn.full_attention(qt, kt, vt, port_config(jcfg))),
        f32(jattn.full_attention(qj, kj, vj, jcfg)), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [0, 48])
def test_chunked_attention_matches_reference(window):
    """The long-prompt path (S > 1024 on the model) at small chunks."""
    jcfg = JaxModelConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                          sliding_window=window)
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 256, 4, 2, 32, "float32")
    cfg = port_config(jcfg)
    out = tattn.chunked_attention(qt, kt, vt, cfg, chunk_q=64, chunk_k=64)
    np.testing.assert_allclose(
        f32(out), f32(jattn.chunked_attention(qj, kj, vj, jcfg, chunk_q=64,
                                              chunk_k=64)),
        atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        f32(out), f32(tattn.full_attention(qt, kt, vt, cfg)),
        atol=2e-4, rtol=2e-4)

"""The sLSTM scan of the port: the plain version against the JAX Pallas
kernel (interpret mode on the CPU), and against the port's own
step-by-step cell at lengths the reference refuses. The CUDA kernel
against the plain version on the card: test_torch_slstm_scan_gpu.py."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.slstm_scan import (  # noqa: E402
    slstm_kernel, slstm_scan_ref)
from repro_torch.models.xlstm import _slstm_cell  # noqa: E402
from torch_parity import f32  # noqa: E402

# float32: the reference kernel test's tolerance; both sides keep float32
# throughout and differ only in summation order. bf16 pre: the math is
# float32 on both sides and only hs is rounded to bf16, so they may differ
# by one bf16 ulp of hs (|h| < 1: 2^-8, 2e-2 as allclose)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(B, S, H, dh, seed, m0=-1e30, nonzero_state=False):
    """numpy (pre, r, c0, n0, m0, h0) as test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    d = H * dh
    pre = rng.standard_normal((B, S, 4, d)).astype(np.float32)
    r = (rng.standard_normal((4, H, dh, dh)) * 0.2).astype(np.float32)
    zeros = np.zeros((B, H, dh), np.float32)
    c0, n0, h0 = zeros, zeros, zeros
    m = np.full((B, H, dh), m0, np.float32)
    if nonzero_state:
        c0 = rng.standard_normal((B, H, dh)).astype(np.float32)
        n0 = (np.abs(rng.standard_normal((B, H, dh))) + 0.5).astype(np.float32)
        m = rng.standard_normal((B, H, dh)).astype(np.float32)
        h0 = np.tanh(rng.standard_normal((B, H, dh))).astype(np.float32)
    return pre, r, c0, n0, m, h0


def _both(arrs, dtype):
    pre, *rest = arrs
    j = [jnp.asarray(pre, JAX_DT[dtype])] + [jnp.asarray(a) for a in rest]
    t = [torch.from_numpy(pre).to(TORCH_DT[dtype])] + [
        torch.from_numpy(a) for a in rest]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def _check_against_jax(arrs, chunk, dtype):
    j, t = _both(arrs, dtype)
    hs_j, st_j = jops.slstm_scan(*j, chunk_t=chunk)
    hs_t, st_t = slstm_scan_ref(*t)
    assert hs_t.dtype == TORCH_DT[dtype]
    _close(hs_t, hs_j, TOL[dtype])
    for a, b in zip(st_t, st_j):
        assert a.dtype == torch.float32
        _close(a, b, 1e-5)


# test_kernels.py::test_slstm_scan_matches_sequential's shapes
@pytest.mark.parametrize("B,S,H,dh,chunk", [
    (1, 32, 2, 16, 8),
    (2, 64, 2, 32, 16),
    (2, 48, 4, 16, 48),
])
def test_plain_matches_reference_kernel(B, S, H, dh, chunk):
    _check_against_jax(_inputs(B, S, H, dh, seed=S), chunk, "float32")


def test_plain_matches_reference_kernel_bf16_pre():
    """bf16 preactivations, as the model's kernel path passes them: hs comes
    back in bf16, the states in float32."""
    _check_against_jax(_inputs(2, 64, 2, 32, seed=7), 16, "bfloat16")


def test_plain_matches_reference_kernel_nonzero_state():
    _check_against_jax(_inputs(2, 48, 4, 16, seed=8, nonzero_state=True),
                       16, "float32")


def test_plain_takes_minus_inf_stabiliser():
    """m0 = -inf (slstm_apply's start without a state): e^{-inf} is 0, no
    NaN, and the result equals starting from -1e30."""
    arrs = _inputs(2, 32, 2, 16, seed=9, m0=-math.inf)
    _check_against_jax(arrs, 8, "float32")
    _, t = _both(arrs, "float32")
    hs, st = slstm_scan_ref(*t)
    assert bool(torch.isfinite(hs).all())
    t[4] = torch.full_like(t[4], -1e30)
    hs2, st2 = slstm_scan_ref(*t)
    _close(hs, hs2, 1e-6)


@pytest.mark.parametrize("S", [37, 300])
def test_plain_matches_step_by_step_cell_at_ragged_lengths(S):
    """Lengths the reference kernel refuses (S % min(256, S) != 0 at 300;
    37 stands for any prompt length): the port's own cell, step by step
    on [B, d] tensors, is the yardstick."""
    B, H, dh = 2, 4, 16
    pre, r, c0, n0, m0, h0 = (torch.from_numpy(a) for a in
                              _inputs(B, S, H, dh, seed=S))
    hs, (cT, nT, mT, hT) = slstm_scan_ref(pre, r, c0, n0, m0, h0)
    d = H * dh
    carry = tuple(s.reshape(B, d) for s in (c0, n0, m0, h0))
    steps = []
    for t in range(S):
        carry = _slstm_cell(r, pre[:, t], carry, H)
        steps.append(carry[3])
    _close(hs, torch.stack(steps, dim=1), 1e-5)
    for got, want in zip((cT, nT, mT, hT), carry):
        _close(got.reshape(B, d), want, 1e-5)


def test_ops_send_cpu_tensors_to_the_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(1, 5, 2, 16, seed=1)]
    before = slstm_kernel.launches
    hs, _ = ops.slstm_scan(*args)
    assert slstm_kernel.launches == before
    torch.testing.assert_close(hs, slstm_scan_ref(*args)[0])


def test_kernel_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper takes CUDA tensors or raises."""
    args = [torch.from_numpy(a) for a in _inputs(1, 5, 2, 16, seed=1)]
    with pytest.raises(ValueError, match="CUDA"):
        slstm_kernel(*args)


def test_plain_versions_switch_restores_dispatch():
    assert not ops._plain["on"]
    with pytest.raises(KeyError):
        with ops.plain_versions():
            assert ops._plain["on"]
            raise KeyError
    assert not ops._plain["on"]
    assert ops.launch_counts().keys() == {"flash_attention", "slstm_scan",
                                          "ssm_scan", "expert_gemm",
                                          "decode_attention"}

"""The selective scan of the port (K3): the plain version and the CPU
dispatch of ``ops.ssm_scan`` against the JAX Pallas kernel (interpret mode
on the CPU) and its sequential oracle ``ref.ssm_scan_ref``; at ragged S
and d, which the Pallas kernel refuses, against the oracle alone. The CUDA
kernel against the plain version on the card: test_torch_ssm_scan_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_kernel, ssm_scan_ref  # noqa: E402
from torch_parity import f32  # noqa: E402

# float32: the reference kernel test's 1e-4 (the same float32 operations,
# summed in another order). bf16 u/B/C: the math is float32 on both sides
# and only y is rounded to bf16 once, one bf16 ulp (2^-8 relative) apart
# at most: the reference tests' 2e-2. The final state stays float32.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(Bb, S, d, N, seed, with_h0=False):
    """numpy (u, dt, A, B, C, D, h0) drawn as test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((Bb, S, d)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (Bb, S, d)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (d, N)).astype(np.float32)
    B = rng.standard_normal((Bb, S, N)).astype(np.float32)
    C = rng.standard_normal((Bb, S, N)).astype(np.float32)
    D = rng.standard_normal((d,)).astype(np.float32)
    h0 = rng.standard_normal((Bb, d, N)).astype(np.float32) if with_h0 \
        else None
    return u, dt, A, B, C, D, h0


def _both(arrs, dtype, dt_dtype=None):
    """The inputs on both sides: u, B and C in ``dtype``, dt in
    ``dt_dtype`` (default ``dtype``), A, D and h0 float32."""
    u, dt, A, B, C, D, h0 = arrs
    dt_dtype = dt_dtype or dtype
    j = [jnp.asarray(u, JAX_DT[dtype]), jnp.asarray(dt, JAX_DT[dt_dtype]),
         jnp.asarray(A), jnp.asarray(B, JAX_DT[dtype]),
         jnp.asarray(C, JAX_DT[dtype]), jnp.asarray(D),
         None if h0 is None else jnp.asarray(h0)]
    t = [torch.from_numpy(u).to(TORCH_DT[dtype]),
         torch.from_numpy(dt).to(TORCH_DT[dt_dtype]), torch.from_numpy(A),
         torch.from_numpy(B).to(TORCH_DT[dtype]),
         torch.from_numpy(C).to(TORCH_DT[dtype]), torch.from_numpy(D),
         None if h0 is None else torch.from_numpy(h0)]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def _check(j, t, dtype, pallas_block=None):
    """The port's plain version and ops.ssm_scan (CPU: the plain version)
    against the reference's oracle and, given a block, its Pallas kernel."""
    *jargs, jh0 = j
    *targs, th0 = t
    want = [jref.ssm_scan_ref(*jargs, h0=jh0)]
    if pallas_block:
        want.append(jops.ssm_scan(*jargs, h0=jh0, block_d=pallas_block))
    before = ssm_kernel.launches
    for y, h in (ssm_scan_ref(*targs, h0=th0), ops.ssm_scan(*targs, h0=th0)):
        assert y.dtype == targs[0].dtype and h.dtype == torch.float32
        for yj, hj in want:
            _close(y, yj, TOL[dtype])
            _close(h, hj, 1e-4)
    assert ssm_kernel.launches == before


# test_kernels.py::test_ssm_scan_matches_ref's shapes and blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bb,S,d,N,bd", [
    (1, 32, 64, 8, 64),
    (2, 64, 128, 16, 64),
    (1, 48, 256, 4, 128),
])
def test_plain_matches_reference_kernel(dtype, Bb, S, d, N, bd):
    j, t = _both(_inputs(Bb, S, d, N, seed=S + d), dtype)
    _check(j, t, dtype, pallas_block=bd)


def test_plain_matches_reference_kernel_with_initial_state():
    """test_kernels.py::test_ssm_scan_with_initial_state."""
    j, t = _both(_inputs(1, 32, 64, 8, seed=3, with_h0=True), "float32")
    _check(j, t, "float32", pallas_block=64)


def test_plain_matches_reference_kernel_model_dtypes():
    """The model's mix: u, B, C bf16 and dt float32 (dt_bias is float32)."""
    j, t = _both(_inputs(2, 64, 128, 16, seed=4, with_h0=True), "bfloat16",
                 dt_dtype="float32")
    assert t[1].dtype == torch.float32
    _check(j, t, "bfloat16", pallas_block=64)


@pytest.mark.parametrize("Bb,S,d,N", [
    (1, 37, 64, 8),     # ragged S
    (2, 100, 128, 16),  # ragged S past the model's chunk of 64
    (1, 20, 200, 16),   # d a multiple of no block
    (2, 1, 48, 4),      # one step
])
def test_plain_matches_reference_oracle_at_ragged_shapes(Bb, S, d, N):
    """Shapes the Pallas kernel refuses (d % block_d != 0): the reference's
    sequential oracle, which takes any shape, is the yardstick."""
    for dtype in ("float32", "bfloat16"):
        j, t = _both(_inputs(Bb, S, d, N, seed=S * d, with_h0=True), dtype)
        _check(j, t, dtype)


def test_kernel_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper takes CUDA tensors or raises."""
    _, t = _both(_inputs(1, 5, 16, 4, seed=1), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ssm_kernel(*t)

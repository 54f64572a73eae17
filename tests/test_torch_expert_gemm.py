"""The grouped expert GEMM of the port (K2): the plain version and the CPU
dispatch of ``ops.expert_gemm`` against the JAX Pallas kernel (interpret
mode on the CPU) at the reference kernel test's shapes and blocks; at
ragged M, N and K, which the Pallas kernel refuses, against the
reference's oracle ``ref.expert_gemm_ref``; and the wrapper's refusals.
The CUDA kernel against the plain version on the card:
test_torch_expert_gemm_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.expert_gemm import (expert_gemm_ref,  # noqa: E402
                                             expert_kernel)
from torch_parity import f32  # noqa: E402

# float32: the same float32 products summed in another order, 1e-5 at
# these depths (K <= 256). bf16: both sides sum exact products in float32
# and round to bf16 once, one bf16 ulp (2^-8 relative) apart at most: the
# reference tests' 2e-2.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(E, M, K, N, seed):
    """numpy x ~ N(0, 1) and w ~ N(0, K^-1/2), as the model scales them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * K ** -0.5).astype(np.float32)
    return x, w


def _close(got, want, dtype):
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,M,K,N,bm,bn,bk", [
    (2, 64, 128, 64, 64, 64, 64),       # test_kernels.py's three shapes
    (4, 128, 256, 128, 64, 64, 128),
    (8, 64, 64, 192, 64, 64, 64),
])
def test_plain_version_matches_pallas_kernel(dtype, E, M, K, N, bm, bn, bk):
    x, w = _inputs(E, M, K, N, seed=E * M + K)
    xj, wj = jnp.asarray(x, JAX_DT[dtype]), jnp.asarray(w, JAX_DT[dtype])
    want = jops.expert_gemm(xj, wj, block_m=bm, block_n=bn, block_k=bk)
    xt = torch.from_numpy(x).to(TORCH_DT[dtype])
    wt = torch.from_numpy(w).to(TORCH_DT[dtype])
    before = expert_kernel.launches
    got = ops.expert_gemm(xt, wt)
    assert expert_kernel.launches == before     # CPU: the plain version
    assert got.dtype == TORCH_DT[dtype] and tuple(got.shape) == (E, M, N)
    _close(got, want, dtype)
    _close(expert_gemm_ref(xt, wt), jref.expert_gemm_ref(xj, wj), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 5, 80])
def test_ragged_m_matches_reference_oracle(dtype, M):
    """Capacities the model gives (4 for a decode step, 80 for Jamba's
    512-token prefill) and others; the Pallas kernel asserts that its
    blocks divide M."""
    x, w = _inputs(3, M, 64, 48, seed=M)
    want = jref.expert_gemm_ref(jnp.asarray(x, JAX_DT[dtype]),
                                jnp.asarray(w, JAX_DT[dtype]))
    got = ops.expert_gemm(torch.from_numpy(x).to(TORCH_DT[dtype]),
                          torch.from_numpy(w).to(TORCH_DT[dtype]))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,M,K,N", [
    (3, 70, 100, 50),     # no dimension a multiple of a block or of 8
    (2, 33, 77, 130),
    (2, 17, 64, 33),      # odd N
])
def test_ragged_n_and_k_match_reference_oracle(dtype, E, M, K, N):
    x, w = _inputs(E, M, K, N, seed=K + N)
    want = jref.expert_gemm_ref(jnp.asarray(x, JAX_DT[dtype]),
                                jnp.asarray(w, JAX_DT[dtype]))
    got = ops.expert_gemm(torch.from_numpy(x).to(TORCH_DT[dtype]),
                          torch.from_numpy(w).to(TORCH_DT[dtype]))
    _close(got, want, dtype)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors only"),
    ("mixed", "both float32 or both bfloat16"),
    ("half", "both float32 or both bfloat16"),
    ("inner", r"want x \[E,M,K\] and w \[E,K,N\]"),
    ("experts", r"want x \[E,M,K\] and w \[E,K,N\]"),
    ("rank", r"want x \[E,M,K\] and w \[E,K,N\]"),
    ("empty", "want each >= 1"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """The kernel's wrapper raises ValueError before it builds or launches
    anything: on CPU tensors, mixed or unsupported dtypes, and shapes that
    do not chain."""
    x = torch.zeros((2, 4, 16))
    w = torch.zeros((2, 16, 8))
    args = {"cpu": (x, w),
            "mixed": (x, w.to(torch.bfloat16)),
            "half": (x.half(), w.half()),
            "inner": (x, torch.zeros((2, 15, 8))),
            "experts": (x, torch.zeros((3, 16, 8))),
            "rank": (x[0], w[0]),
            "empty": (torch.zeros((2, 0, 16)), w)}[case]
    before = expert_kernel.launches
    with pytest.raises(ValueError, match=match):
        expert_kernel(*args)
    assert expert_kernel.launches == before
    assert expert_kernel._lib is None

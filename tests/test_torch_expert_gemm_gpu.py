"""The grouped expert GEMM CUDA kernel against its plain version, on the
card.

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_expert_gemm_gpu.py

Without a CUDA card every case skips.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.expert_gemm import (expert_gemm_ref,  # noqa: E402
                                             expert_kernel)

# bf16: both sum the exact bf16 x bf16 products in float32 and round the
# sum to bf16 once, at most one bf16 ulp (2^-8 relative) apart: 2e-2.
# float32: sums of up to 14,336 products in another order, O(1) results:
# 1e-4. No TF32 on either side.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _inputs(E, M, K, N, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((E, M, K), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((E, K, N), generator=gen, device="cuda")
         * K ** -0.5).to(dtype)
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,M,K,N", [
    (2, 64, 128, 64),         # the reference kernel test's shapes
    (4, 128, 256, 128),
    (8, 64, 64, 192),
    (3, 70, 100, 50),         # ragged M, N and K
    (2, 33, 77, 130),
    (2, 17, 64, 33),          # odd N
    (4, 1, 256, 384),         # M = 1
    (4, 4, 512, 256),         # M = 4
    (32, 160, 1024, 512),     # granite's prefill, up/gate and down
    (32, 160, 512, 1024),
    (16, 80, 4096, 14336),    # jamba's prefill, up/gate and down
    (16, 80, 14336, 4096),
    (16, 4, 4096, 14336),     # jamba's 8-lane decode step
])
def test_kernel_matches_plain_on_card(dtype, E, M, K, N):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    x, w = _inputs(E, M, K, N, dt, seed=E * M + K + N)
    before = expert_kernel.launches
    out = ops.expert_gemm(x, w)
    torch.cuda.synchronize()
    assert expert_kernel.launches == before + 1
    assert out.dtype == dt and out.shape == (E, M, N)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), expert_gemm_ref(x, w).float(),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.gpu
def test_kernel_takes_non_contiguous_inputs():
    """The MoE block hands it views; the wrapper makes them contiguous."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    x, w = _inputs(4, 40, 64, 96, torch.bfloat16, seed=1)
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)
    wt = w.transpose(1, 2).contiguous().transpose(1, 2)
    assert not xt.is_contiguous() and not wt.is_contiguous()
    torch.testing.assert_close(expert_kernel(xt, wt).float(),
                               expert_gemm_ref(x, w).float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    x, w = _inputs(2, 8, 32, 16, torch.float32, seed=0)
    before = expert_kernel.launches
    for args in ((x, w.to(torch.bfloat16)), (x.half(), w.half()),
                 (x.double(), w.double()), (x, w.cpu()),
                 (x, w[:, :31]), (x, w[:1]), (x[0], w[0]),
                 (x[:, :0], w)):
        with pytest.raises(ValueError):
            expert_kernel(*args)
    assert expert_kernel.launches == before


@pytest.mark.gpu
def test_launches_count_kernel_calls_only():
    """One per launch of the kernel; the plain version and the
    plain_versions() switch add none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    x, w = _inputs(2, 8, 32, 16, torch.bfloat16, seed=2)
    before = expert_kernel.launches
    ops.expert_gemm(x, w)
    expert_kernel(x, w)
    assert expert_kernel.launches == before + 2
    expert_gemm_ref(x, w)
    with ops.plain_versions():
        ops.expert_gemm(x, w)
    torch.cuda.synchronize()
    assert expert_kernel.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("E,M,K,N", [
    (4, 4, 512, 1024),       # a decode step's capacity: wgmma N = 8
    (4, 80, 1024, 512),      # Jamba's 512-token capacity
    (4, 160, 512, 1024),     # Granite's
    (2, 300, 256, 512),      # above 256: two capacity chunks, ragged
    (2, 320, 512, 256),      # Jamba's 2,048-token capacity
    (3, 72, 200, 136),       # K and N multiples of 8 but not of the tiles
])
def test_wgmma_body_over_capacities(E, M, K, N):
    """bf16 with K and N multiples of 8 takes the TMA + wgmma body at every
    capacity M; rows, columns and k past the edges load as zeros and are
    masked on store."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    x, w = _inputs(E, M, K, N, torch.bfloat16, seed=E + M + K + N)
    before = expert_kernel.launches_by_body.get("wgmma", 0)
    out = expert_kernel(x, w)
    torch.cuda.synchronize()
    assert expert_kernel.launches_by_body["wgmma"] == before + 1
    assert out.shape == (E, M, N) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), expert_gemm_ref(x, w).float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.gpu
def test_main_path_shapes_take_the_wgmma_body():
    """Granite's and Jamba's prefill products and Jamba's decode shape
    each launch once, in the wgmma body; the ragged shapes stay on
    mma_sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    expert_kernel.reset_counts()
    for E, M, K, N in ((32, 160, 1024, 512), (32, 160, 512, 1024),
                       (16, 80, 4096, 14336), (16, 80, 14336, 4096),
                       (16, 4, 4096, 14336)):
        x, w = _inputs(E, M, K, N, torch.bfloat16, seed=M)
        expert_kernel(x, w)
        del x, w
    for E, M, K, N in ((3, 70, 100, 50), (2, 17, 64, 33)):
        expert_kernel(*_inputs(E, M, K, N, torch.bfloat16, seed=M))
    torch.cuda.synchronize()
    assert expert_kernel.launches_by_body == {"wgmma": 5, "mma_sync": 2}
    assert expert_kernel.launches == 7


@pytest.mark.gpu
def test_wgmma_body_from_new_threads():
    """K2 launched from threads whose first CUDA work takes a cached block:
    bind_context makes the context its tensor maps need; the outputs equal
    the main thread's bit for bit."""
    import threading

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((8, 64, 512), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.randn((8, 512, 256), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    want = ops.expert_gemm(x, w)
    ops.expert_gemm(x, w)                       # freed: a cached block
    torch.cuda.synchronize()
    outs, errors = {}, []

    def run(i):
        try:
            outs[i] = ops.expert_gemm(x, w)
            torch.cuda.current_stream().synchronize()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
        th.join()
    assert not errors
    assert all(torch.equal(outs[i], want) for i in range(8))

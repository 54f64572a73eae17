"""The selective-scan CUDA kernel against its plain version, on the card.

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssm_scan_gpu.py

Without a CUDA card every case skips.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_kernel, ssm_scan_ref  # noqa: E402

# float32: the kernel keeps float32 from load to store and differs from the
# plain version only in the order of the sum over the state, 1e-5. bf16
# u/B/C: the math is still float32 and only y is rounded to bf16 at the
# end, one bf16 ulp (2^-8 relative) apart at most: 2e-2. The final state
# is float32 either way: 1e-5.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _inputs(Bb, S, d, N, dtype, dt_dtype, with_h0, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u = randn(Bb, S, d).to(dtype)
    dt = (rand(Bb, S, d) * 0.099 + 1e-3).to(dt_dtype)
    A = -(rand(d, N) * 1.5 + 0.5)
    B = randn(Bb, S, N).to(dtype)
    C = randn(Bb, S, N).to(dtype)
    D = randn(d)
    h0 = randn(Bb, d, N) if with_h0 else None
    return u, dt, A, B, C, D, h0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bb,S,d,N,with_h0,dt_f32", [
    (1, 32, 64, 8, False, False),     # the reference kernel test's shapes
    (2, 64, 128, 16, False, False),
    (1, 48, 256, 4, False, False),
    (1, 32, 64, 8, True, False),      # an initial state
    (1, 37, 64, 8, False, False),     # ragged S
    (2, 100, 128, 16, True, False),   # ragged S past a chunk
    (1, 20, 200, 16, True, False),    # d a multiple of no block
    (2, 64, 256, 16, True, True),     # the model's dtypes: dt float32
    (1, 512, 8192, 16, True, True),   # jamba's prefill at full width
])
def test_kernel_matches_plain_on_card(dtype, Bb, S, d, N, with_h0, dt_f32):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    dt_ = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    args = _inputs(Bb, S, d, N, dt_, torch.float32 if dt_f32 else dt_,
                   with_h0, seed=S * d + Bb)
    before = ssm_kernel.launches
    y, h = ops.ssm_scan(*args[:6], h0=args[6])
    torch.cuda.synchronize()
    assert ssm_kernel.launches == before + 1
    y_ref, h_ref = ssm_scan_ref(*args[:6], h0=args[6])
    assert y.dtype == dt_ and y.shape == (Bb, S, d)
    assert h.dtype == torch.float32 and h.shape == (Bb, d, N)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=TOL[dt_],
                               rtol=TOL[dt_])
    torch.testing.assert_close(h, h_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8192, 1000])
@pytest.mark.parametrize("S", [1, 513])
@pytest.mark.parametrize("N", [4, 8, 16])
def test_ring_body_at_its_edges(dtype, N, S, d):
    """The ring body over its lane splits (N = 4, 8, 16: one, two, four
    states a lane), one step and a chunk past 512, Jamba's width and a
    width no block of 32 channels divides; dt float32 as in the model."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    dt_ = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    args = _inputs(1, S, d, N, dt_, torch.float32, True, seed=S + d + N)
    before = ssm_kernel.launches_by_body.get("ring", 0)
    y, h = ops.ssm_scan(*args[:6], h0=args[6])
    torch.cuda.synchronize()
    assert ssm_kernel.launches_by_body["ring"] == before + 1
    y_ref, h_ref = ssm_scan_ref(*args[:6], h0=args[6])
    torch.testing.assert_close(y.float(), y_ref.float(), atol=TOL[dt_],
                               rtol=TOL[dt_])
    torch.testing.assert_close(h, h_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    u, dt, A, B, C, D, h0 = _inputs(1, 8, 32, 8, torch.float32,
                                    torch.float32, True, seed=0)
    with pytest.raises(ValueError):
        ssm_kernel(u.half(), dt, A, B, C, D, h0)
    with pytest.raises(ValueError):
        ssm_kernel(u, dt, A.cpu(), B, C, D, h0)
    with pytest.raises(ValueError):
        ssm_kernel(u, dt, A.double(), B, C, D, h0)
    with pytest.raises(ValueError):      # B in another dtype than u
        ssm_kernel(u, dt, A, B.bfloat16(), C, D, h0)
    with pytest.raises(ValueError):      # N above what the kernel holds
        big = torch.zeros((32, 65), device="cuda")
        ssm_kernel(u, dt, big, torch.zeros((1, 8, 65), device="cuda"),
                   torch.zeros((1, 8, 65), device="cuda"), D)

"""The sLSTM scan CUDA kernel against its plain version, on the card.

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_slstm_scan_gpu.py

Without a CUDA card every case skips.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.slstm_scan import (  # noqa: E402
    slstm_kernel, slstm_scan_ref)

# float32: the kernel keeps float32 from load to store and differs from the
# plain version only in the order of the recurrent dot products' sums, so
# the reference kernel test's 1e-5 holds. bfloat16 pre: the math is still
# float32 and only hs is rounded to bf16 at the end, so the two differ by
# at most one bf16 ulp of hs (|h| < 1: 2^-8 relative, 2e-2 as allclose).
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _inputs(B, S, H, dh, dtype, m0, nonzero_state, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = H * dh

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    pre = randn(B, S, 4, d).to(dtype)
    r = randn(4, H, dh, dh, scale=dh ** -0.5)
    zeros = torch.zeros((B, H, dh), device="cuda")
    c0, n0, h0 = zeros, zeros, zeros
    m = torch.full((B, H, dh), m0, device="cuda")
    if nonzero_state:
        c0 = randn(B, H, dh)
        n0 = randn(B, H, dh).abs() + 0.5
        m = randn(B, H, dh)
        h0 = torch.tanh(randn(B, H, dh))
    return pre, r, c0, n0, m, h0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dh,m0,nonzero_state", [
    (1, 32, 2, 16, -1e30, False),      # the reference kernel test's shapes
    (2, 64, 2, 32, -1e30, False),
    (2, 48, 4, 16, -1e30, False),
    (1, 37, 2, 32, -math.inf, False),  # ragged S, m0 = -inf (no state)
    (2, 300, 4, 16, -1e30, False),     # ragged S past the TPU chunk
    (3, 50, 2, 24, 0.0, True),         # a nonzero state, dh not /16
    (1, 512, 4, 512, -1e30, False),    # xlstm_1_3b's sLSTM at full width
])
def test_kernel_matches_plain_on_card(dtype, B, S, H, dh, m0, nonzero_state):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    args = _inputs(B, S, H, dh, dt, m0, nonzero_state, seed=S * dh + B)
    before = slstm_kernel.launches
    hs, state = ops.slstm_scan(*args)
    torch.cuda.synchronize()
    assert slstm_kernel.launches == before + 1
    hs_ref, state_ref = slstm_scan_ref(*args)
    assert hs.dtype == dt and hs.shape == (B, S, H * dh)
    torch.testing.assert_close(hs.float(), hs_ref.float(), atol=TOL[dt],
                               rtol=TOL[dt])
    # the final states are float32 either way: the float32 tolerance
    for got, want in zip(state, state_ref):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 37, 512])
@pytest.mark.parametrize("dh", [64, 128, 512])
@pytest.mark.parametrize("B", [1, 2, 4])
def test_kernel_at_its_edges(B, dh, S):
    """Batch rows, head dims from one float4 round a lane (half the lanes
    padded at 64) to four, one step to xLSTM's prompt length, from
    m0 = -inf; float32, so at 1e-5. Every launch counts as the regs
    body."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    args = _inputs(B, S, 2, dh, torch.float32, -math.inf, False,
                   seed=7 * S + dh + B)
    before = slstm_kernel.launches_by_body.get("regs", 0)
    hs, state = ops.slstm_scan(*args)
    torch.cuda.synchronize()
    assert slstm_kernel.launches_by_body["regs"] == before + 1
    hs_ref, state_ref = slstm_scan_ref(*args)
    torch.testing.assert_close(hs, hs_ref, atol=1e-5, rtol=1e-5)
    for got, want in zip(state, state_ref):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    pre, r, c0, n0, m0, h0 = _inputs(1, 8, 2, 16, torch.float32, -1e30,
                                     False, seed=0)
    with pytest.raises(ValueError):
        slstm_kernel(pre.half(), r, c0, n0, m0, h0)
    with pytest.raises(ValueError):
        slstm_kernel(pre, r.cpu(), c0, n0, m0, h0)
    big = torch.zeros((1, 2, 4, 2 * 1024), device="cuda")
    with pytest.raises(ValueError):
        slstm_kernel(big, torch.zeros((4, 2, 1024, 1024), device="cuda"),
                     *(torch.zeros((1, 2, 1024), device="cuda"),) * 4)

"""Kernel K1 at latent attention's prefill shape against its plain
version, on the card: q·k over 192 dims (qk_nope 128 + qk_rope 64) and v
over 128, zero-padded to K1's head dim 256, scores scaled by 192^-0.5.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mla_flash_attention_gpu.py

Without a CUDA card every case skips.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_ref, flash_kernel)
from repro_torch.models.mla import padded_flash_attention  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1000, 4097])
def test_k1_at_the_mla_shape(S):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    gen = torch.Generator(device="cuda").manual_seed(S)
    q, k = (torch.randn((1, S, 16, 192), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    v = torch.randn((1, S, 16, 128), generator=gen, device="cuda").bfloat16()
    before = flash_kernel.launches
    out = padded_flash_attention(q, k, v, 192 ** -0.5)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    assert out.shape == v.shape
    # bf16 as the kernel's other bf16 cases: P rounded to bf16 for the
    # tensor cores, outputs within about one bf16 ulp
    want = flash_attention_ref(q, k, v, causal=True, scale=192 ** -0.5)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)

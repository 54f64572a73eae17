"""The flash-attention CUDA kernel against its plain version, on the card.

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_attention_gpu.py

Without a CUDA card every case skips.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_ref, flash_kernel)

# allclose tolerances: bf16 as the reference kernel tests (the kernel
# rounds P to bf16 for the tensor cores; outputs differ by about one bf16
# ulp); float32 tighter, since that body keeps float32 throughout and
# differs only in summation order
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", [
    (1, 512, 24, 8, 128, True, 0, 0.0),    # phi4-mini prefill
    (1, 37, 24, 8, 128, True, 0, 0.0),     # ragged
    (2, 130, 4, 1, 32, True, 0, 0.0),      # gemma smoke (MQA, hd 32)
    (1, 100, 4, 2, 16, True, 0, 0.0),      # phi4 smoke (hd 16)
    (1, 300, 8, 1, 256, True, 0, 0.0),     # gemma full (hd 256)
    (1, 300, 4, 2, 64, True, 64, 0.0),     # sliding window
    (1, 200, 4, 2, 128, True, 0, 20.0),    # softcap
    (1, 150, 4, 2, 64, False, 0, 0.0),     # not causal
])
def test_kernel_matches_plain_on_card(dtype, B, S, Hq, Hkv, hd, causal,
                                      window, softcap):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    gen = torch.Generator(device="cuda").manual_seed(S * hd)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
               for shape in ((B, S, Hq, hd), (B, S, Hkv, hd),
                             (B, S, Hkv, hd)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_kernel.launches
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    torch.testing.assert_close(out.float(),
                               flash_attention_ref(q, k, v, **kw).float(),
                               atol=TOL[dt], rtol=TOL[dt])

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


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,L,Hq,Hkv,hd,causal,window,softcap", [
    (1, 512, 512, 1024, 24, 8, 128, True, 0, 0.0),   # phi4 prefill
    (1, 512, 512, 1024, 16, 8, 64, True, 0, 0.0),    # granite prefill
    (1, 481, 481, 1024, 32, 8, 128, True, 0, 0.0),   # jamba, ragged T
    (2, 37, 37, 64, 4, 2, 128, True, 0, 0.0),        # T < 64: one partial box
    (1, 100, 100, 128, 4, 1, 64, True, 0, 0.0),      # MQA, ragged
    (1, 300, 300, 400, 4, 2, 64, True, 64, 0.0),     # window
    (1, 200, 200, 256, 4, 2, 128, True, 0, 20.0),    # softcap
    (1, 70, 130, 192, 4, 2, 128, False, 0, 0.0),     # T > S, not causal
])
def test_wgmma_body_on_cache_views(B, S, T, L, Hq, Hkv, hd, causal, window,
                                   softcap):
    """bf16 at hd 64 and 128 takes the TMA + wgmma body; k and v are views
    [:, :T] into a longer cache [B, L, Hkv, hd] as on the serving path, so
    the tensor maps must take their strides and T (rows past T load as
    zeros), not L."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    gen = torch.Generator(device="cuda").manual_seed(S * hd + T)
    q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda").bfloat16()
    ck, cv = (torch.randn((B, L, Hkv, hd), generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    k, v = ck[:, :T], cv[:, :T]
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_kernel.launches_by_body.get("wgmma", 0)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_kernel.launches_by_body["wgmma"] == before + 1
    torch.testing.assert_close(out.float(),
                               flash_attention_ref(q, k, v, **kw).float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("hd,body", [(16, "mma_sync"), (32, "mma_sync"),
                                     (64, "wgmma"), (128, "wgmma"),
                                     (256, "mma_sync")])
def test_launches_by_body(hd, body):
    """Each bf16 launch is counted once, under the body it took."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    gen = torch.Generator(device="cuda").manual_seed(hd)
    q, k, v = (torch.randn((1, 70, 2, hd), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    before = dict(flash_kernel.launches_by_body)
    total = flash_kernel.launches
    flash_kernel(q, k, v)
    torch.cuda.synchronize()
    assert flash_kernel.launches == total + 1
    after = dict(flash_kernel.launches_by_body)
    assert after.pop(body) == before.pop(body, 0) + 1
    assert after == before


@pytest.mark.gpu
def test_wgmma_body_from_new_threads():
    """K1 launched from threads whose first CUDA work takes a cached block
    (as a worker slot of repro_torch.rt does): the tensor-map encode needs
    a current context, which bind_context makes; the outputs equal the
    main thread's bit for bit."""
    import threading

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
               for shape in ((1, 512, 24, 128), (1, 512, 8, 128),
                             (1, 512, 8, 128)))
    want = ops.flash_attention(q, k, v, causal=True)
    ops.flash_attention(q, k, v, causal=True)    # freed: a cached block
    torch.cuda.synchronize()
    outs, errors = {}, []

    def run(i):
        try:
            outs[i] = ops.flash_attention(q, k, v, causal=True)
            torch.cuda.current_stream().synchronize()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
        th.join()
    assert not errors
    assert all(torch.equal(outs[i], want) for i in range(8))

"""The decode-attention CUDA kernel against its plain version, on the card.

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decode_attention_gpu.py

Without a CUDA card every case skips.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_ref, decode_kernel)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServeRequest, ServingEngine  # noqa: E402

# allclose tolerances against the plain version in the working dtype: bf16
# as the flash-attention kernel tests (the plain version rounds its logits
# and probabilities to bf16, the kernel its P for the tensor cores: outputs
# differ by about one bf16 ulp of the inputs); float32 tighter, since both
# keep float32 throughout and differ only in summation order and exp
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# bf16 against the plain version run on float32 copies of the inputs: the
# kernel's only roundings are P to bf16 (2^-9 relative) and its output
TOL_F32_REF = 1e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")


def _inputs(B, L, Hq, Hkv, hd, dtype, seed, q_scale=2.0):
    """q scaled so that the softmax is peaked and outputs are O(1) even
    over thousands of positions."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, 1, Hq, hd), generator=gen, device="cuda") * q_scale
    ck, cv = (torch.randn((B, L, Hkv, hd), generator=gen, device="cuda")
              for _ in range(2))
    return q.to(dtype), ck.to(dtype), cv.to(dtype)


def _ragged(B, L, seed):
    """Positions spread over [0, L): 0, 1 and L - 1 among them."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, L, B)
    idx[:3] = [0, 1, L - 1][:B]
    return torch.as_tensor(idx, device="cuda")


def _check(out, q, ck, cv, index, window=0, softcap=0.0):
    kw = dict(window=window, softcap=softcap)
    assert bool(torch.isfinite(out).all())
    want = decode_attention_ref(q, ck, cv, index, **kw)
    tol = TOL[q.dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    if q.dtype == torch.bfloat16:
        exact = decode_attention_ref(q.float(), ck.float(), cv.float(),
                                     index, **kw)
        torch.testing.assert_close(out.float(), exact, atol=TOL_F32_REF,
                                   rtol=TOL_F32_REF)


@pytest.mark.gpu
def test_kernel_at_the_serving_cells_shapes():
    """phi4-serve-longdoc's decode: 32 lanes of an 8,256-position cache, 24
    query heads over 8 kv heads, hd 128, bf16; positions 0, 1, 1,023, L - 1
    and 28 spread log-uniform over 1,024-8,192."""
    _need_card()
    B, L, Hq, Hkv, hd = 32, 8256, 24, 8, 128
    q, ck, cv = _inputs(B, L, Hq, Hkv, hd, torch.bfloat16, seed=0)
    rng = np.random.default_rng(1)
    spread = np.exp(rng.uniform(np.log(1024), np.log(8192), B - 4))
    index = torch.as_tensor(np.concatenate(
        [[0, 1, 1023, L - 1], spread.astype(np.int64)]), device="cuda")
    before = decode_kernel.launches_by_body.get("mma", 0)
    out = ops.decode_attention(q, ck, cv, index)
    torch.cuda.synchronize()
    assert decode_kernel.launches_by_body["mma"] == before + 1
    _check(out, q, ck, cv, index)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,Hq,Hkv,hd,window,softcap", [
    (3, 100, 6, 2, 16, 0, 0.0),       # phi4 smoke's head dim, G 3
    (2, 130, 4, 1, 32, 0, 0.0),       # gemma smoke: MQA, hd 32
    (2, 300, 8, 1, 256, 0, 0.0),      # gemma full: MQA, hd 256, G 8
    (2, 700, 16, 8, 64, 0, 0.0),      # granite: hd 64, G 2, many splits
    (3, 300, 4, 2, 64, 64, 0.0),      # sliding window
    (2, 200, 6, 2, 128, 0, 20.0),     # softcap
    (3, 1200, 6, 2, 128, 100, 30.0),  # window and softcap, many splits
    (2, 600, 32, 2, 128, 0, 0.0),     # chatglm: G 16, one row tile
    (2, 300, 40, 2, 64, 0, 0.0),      # G 20: two row tiles
])
def test_kernel_matches_plain_on_card(dtype, B, L, Hq, Hkv, hd, window,
                                      softcap):
    _need_card()
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    q, ck, cv = _inputs(B, L, Hq, Hkv, hd, dt, seed=L * hd + Hq)
    for index in (_ragged(B, L, seed=L), L // 2):
        out = ops.decode_attention(q, ck, cv, index, window=window,
                                   softcap=softcap)
        torch.cuda.synchronize()
        _check(out, q, ck, cv, index, window, softcap)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd,window,split", [
    ("bfloat16", 128, 0, None),
    ("bfloat16", 128, 0, 16),
    ("bfloat16", 64, 48, 64),
    ("float32", 128, 0, None),
    ("float32", 32, 48, 32),
])
def test_no_position_past_a_lane_or_outside_its_window_is_read(
        dtype, hd, window, split):
    """NaN in k and v after each lane's position and before its window:
    a read of one of them would make the output NaN."""
    _need_card()
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    B, L, Hq, Hkv = 6, 1000, 6, 2
    q, ck, cv = _inputs(B, L, Hq, Hkv, hd, dt, seed=hd + window)
    index = _ragged(B, L, seed=7)
    pos = torch.arange(L, device="cuda")[None, :]
    outside = pos > index[:, None]
    if window:
        outside |= pos <= index[:, None] - window
    pk, pv = ck.clone(), cv.clone()
    pk[outside] = float("nan")
    pv[outside] = float("nan")
    out = decode_kernel(q, pk, pv, index, window=window, split=split)
    torch.cuda.synchronize()
    _check(out, q, ck, cv, index, window)


@pytest.mark.gpu
def test_one_launch_a_layer_a_decode_step_through_the_engine():
    _need_card()
    cfg = get_smoke_config("phi4_mini_3_8b")
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                         max_new_tokens=5) for n in (7, 30, 12, 64, 3)]
    engine = ServingEngine(cfg, params, lanes=3, max_len=128)
    decode_kernel.reset_counts()
    stats = engine.run(reqs)
    torch.cuda.synchronize()
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    # the steps are replayed as CUDA graphs, captured after one eager step
    assert stats["decode_captures"] == 1
    assert decode_kernel.launches_by_body == {
        "mma": (engine.steps + 1) * attn}
    assert all(len(r.output) == 5 and all(0 <= t < cfg.vocab_size
                                          for t in r.output) for r in reqs)

"""The decode-attention dispatch on the CPU: ``ops.decode_attention``
against the models' plain decode attention bit for bit, the engine's
kernel path against its plain path token for token, what a decode step
sends through ``ops`` and what it refuses. The CUDA kernel itself is held
against its plain version on the card in
``test_torch_decode_attention_gpu.py``."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    BLOCKS_PER_SM, FMA_SPLIT, _split_for, decode_kernel)
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.serving import ServeRequest, ServingEngine  # noqa: E402


def _inputs(B, L, Hq, Hkv, hd, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, Hq, hd), generator=gen).to(dtype)
    ck, cv = (torch.randn((B, L, Hkv, hd), generator=gen).to(dtype)
              for _ in range(2))
    return q, ck, cv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", ["int", "ragged"])
@pytest.mark.parametrize("B,L,Hq,Hkv,hd,window,softcap", [
    (3, 40, 6, 2, 16, 0, 0.0),      # phi4 smoke's head dim, G 3
    (2, 48, 4, 1, 32, 0, 0.0),      # gemma smoke: MQA, hd 32
    (3, 64, 4, 2, 64, 16, 0.0),     # hd 64, sliding window
    (2, 33, 6, 2, 128, 0, 30.0),    # hd 128, softcap
])
def test_ops_equals_the_plain_decode_attention_bit_for_bit(
        B, L, Hq, Hkv, hd, window, softcap, index, dtype):
    q, ck, cv = _inputs(B, L, Hq, Hkv, hd, dtype, seed=B * L + hd)
    cache_index = (L // 2 if index == "int"
                   else torch.tensor([0, L - 1, L // 3][:B]))
    cfg = SimpleNamespace(sliding_window=window, attn_logit_softcap=softcap)
    out = ops.decode_attention(q, ck, cv, cache_index, window=window,
                               softcap=softcap)
    want = attention.decode_attention(q, ck, cv, cache_index, cfg)
    assert out.dtype == dtype and out.shape == (B, 1, Hq, hd)
    assert torch.equal(out, want)


def _attn_layers(cfg) -> int:
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def _spy(monkeypatch, name) -> list:
    calls = []
    real = getattr(ops, name)

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(ops, name, spy)
    return calls


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "gemma_2b"])
def test_engine_serves_the_same_tokens_through_the_decode_dispatch(
        arch, monkeypatch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 17, 9, 30, 12)]
    calls = _spy(monkeypatch, "decode_attention")
    outputs, steps = {}, {}
    for use_kernel in (False, True):
        reqs = [ServeRequest(prompt=p, max_new_tokens=6) for p in prompts]
        engine = ServingEngine(cfg, params, lanes=3, max_len=64,
                               use_kernel=use_kernel)
        engine.run(reqs)
        outputs[use_kernel] = [r.output for r in reqs]
        steps[use_kernel] = engine.steps
        if not use_kernel:
            assert calls == []
    assert outputs[True] == outputs[False]
    assert all(len(o) == 6 for o in outputs[True])
    # one call a layer a decode step, on every lane at once
    assert calls == [(3, 1, cfg.n_heads, cfg.resolved_head_dim)] * (
        steps[True] * _attn_layers(cfg))


def test_a_decode_step_sends_only_attention_through_ops(monkeypatch):
    """Granite-MoE: with ``decode_kernel`` a decode step's attention goes
    through ``ops.decode_attention`` and its expert products stay einsums
    (a prefill's go through ``ops.expert_gemm``); without it nothing of a
    decode step does."""
    cfg = get_smoke_config("granite_moe_1b_a400m")
    model = build_model(cfg, decode_kernel=True)
    params = model.init(0, device="cpu")
    attn = _spy(monkeypatch, "decode_attention")
    gemm = _spy(monkeypatch, "expert_gemm")
    prompt = torch.arange(1, 9)[None]
    _, caches = model.prefill(params, prompt, max_len=16, use_kernel=True)
    assert attn == [] and len(gemm) == 3 * cfg.n_layers
    gemm.clear()
    model.decode_step(params, torch.tensor([[3]]), caches,
                      torch.tensor([8]))
    assert len(attn) == _attn_layers(cfg) and gemm == []
    build_model(cfg).decode_step(params, torch.tensor([[3]]), caches,
                                 torch.tensor([9]))
    assert len(attn) == _attn_layers(cfg) and gemm == []


def test_decode_kernel_path_is_refused_under_grad():
    """``ops`` refuses an input that requires grad under grad mode: the
    kernel passes no gradient back. ``Model.decode_step`` runs under
    ``no_grad``, so its kernel path never meets one; the model's own call
    under the caller's grad mode does."""
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                              dtype="float32")
    model = build_model(cfg, decode_kernel=True)
    params = model.init(0, device="cpu")
    for t in params["stack"]["pos00"]["mixer"].values():
        t.requires_grad_(True)
    token, index = torch.tensor([[1], [2]]), torch.tensor([3, 5])
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="forward-only"):
            model._apply(params, token, caches=model.init_caches(2, 16, "cpu"),
                         cache_index=index, use_kernel=True)
        logits, _, _ = model._apply(
            params, token, caches=model.init_caches(2, 16, "cpu"),
            cache_index=index, use_kernel=False)
        assert logits.requires_grad
        logits, _ = model.decode_step(
            params, token, model.init_caches(2, 16, "cpu"), index)
    assert not logits.requires_grad


def test_the_kernel_is_counted_by_ops():
    assert "decode_attention" in ops.launch_counts()
    assert ops.KERNELS["decode_attention"] is decode_kernel


def test_the_kernel_refuses_cpu_tensors():
    q, ck, cv = _inputs(2, 16, 4, 2, 16, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        decode_kernel(q, ck, cv, 3)


@pytest.mark.parametrize("dtype,B,Hkv,span,want", [
    (torch.bfloat16, 32, 8, 8256, 512),   # phi4 serving: 4,352 blocks
    (torch.bfloat16, 16, 8, 1024, 128),   # 16 lanes of 1,024: 1,024 blocks
    (torch.bfloat16, 1, 1, 8192, 64),     # one MQA lane: as small as it goes
    (torch.float32, 32, 8, 8256, FMA_SPLIT),
])
def test_split_fills_the_card(dtype, B, Hkv, span, want):
    split = _split_for(dtype, B, Hkv, span, sms=132)
    assert split == want
    if dtype == torch.bfloat16 and split > 64:
        assert B * Hkv * -(-span // split) >= BLOCKS_PER_SM * 132

"""Moonlight-16B-A3B (DeepSeek-V3 blocks) on the port, at the smoke
config's sizes on the CPU: latent attention's absorbed decode against its
expanded form, serving through the engine against the benchmark's plain
reference (``perfbench/reference/moonlight.py``, loaded by file path),
sigmoid routing with a selection bias, dropless dispatch, the full-size
parameter count and the spans. Logits are compared, not tokens."""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import decode_graph, mla, moe  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.obs.spans import SPANS  # noqa: E402
from repro_torch.serving import ServeRequest, ServingEngine  # noqa: E402

ARCH = "moonlight_16b_a3b"
_PATH = (Path(__file__).resolve().parents[1] / "perfbench" / "reference"
         / "moonlight.py")


def _reference():
    spec = importlib.util.spec_from_file_location("moonlight_reference",
                                                  _PATH)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod         # dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


ref = _reference()


def smoke(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


def params_of(cfg, seed=0):
    return ref.make_params(dataclasses.asdict(cfg), seed, "cpu")


def test_smoke_config_keeps_the_shape():
    cfg = smoke()
    assert [cfg.layer_is_moe(i) for i in range(cfg.n_layers)] == [
        False, True, True]
    assert {cfg.layer_kind(i) for i in range(cfg.n_layers)} == {"mla"}
    assert cfg.moe.n_experts >= 8 and cfg.moe.top_k >= 3
    assert cfg.mla.kv_lora_rank >= 32 and cfg.mla.qk_rope_head_dim == 8


def test_absorbed_decode_equals_the_expanded_form():
    """(a) A decode step over the latent cache (absorbed) gives the
    expanded form's output at the last position."""
    cfg = smoke()
    p = params_of(cfg)["stack"]["pos01"]["mixer"]
    p = {k: (v[0] if torch.is_tensor(v) else {"scale": v["scale"][0]})
         for k, v in p.items()}
    x = torch.randn(2, 23, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    pos = torch.arange(23)[None]
    full = mla.mla_apply(p, x, pos, cfg)
    cache = mla.init_cache(cfg, 2, 40, torch.float32)
    mla.mla_apply(p, x[:, :22], pos[:, :22], cfg, cache=cache, cache_index=0)
    lanes = torch.tensor([22, 22])
    step = mla.mla_apply(p, x[:, 22:], lanes[:, None], cfg, cache=cache,
                         cache_index=lanes)
    torch.testing.assert_close(step[:, 0], full[:, 22], atol=1e-5, rtol=1e-5)


def test_padded_k1_call_is_exact_on_the_plain_version():
    """K1's route for MLA (q, k, v zero-padded to the next head dim,
    ``scale`` passed) equals the unpadded plain attention."""
    g = torch.Generator().manual_seed(2)
    q, k = (torch.randn(1, 29, 4, 24, generator=g) for _ in range(2))
    v = torch.randn(1, 29, 4, 16, generator=g)
    torch.testing.assert_close(
        mla.padded_flash_attention(q, k, v, 24 ** -0.5),
        flash_attention_ref(q, k, v, scale=24 ** -0.5), atol=1e-6, rtol=1e-6)


class _Spy:
    """The engine's model, recording the logits each call produced."""

    def __init__(self, engine):
        self._model, self._engine = engine.model, engine
        self.logits = {}            # request id -> [logits rows]

    def prefill(self, params, tokens, *args, **kw):
        last, caches = self._model.prefill(params, tokens, *args, **kw)
        self.logits[tuple(tokens[0].tolist())] = [last[0]]
        return last, caches

    def decode_step(self, params, token, caches, cache_index):
        logits, caches = self._model.decode_step(params, token, caches,
                                                 cache_index)
        for lane, r in enumerate(self._engine.lane_req):
            if r is not None:
                self.logits[tuple(r.prompt)].append(logits[lane])
        return logits, caches

    def __getattr__(self, name):
        return getattr(self._model, name)


def _serve(cfg, params):
    """Four ragged prompts on three lanes: (request, program logits
    [n_out, V], reference logits [n_out, V], the reference's own bf16
    logits)."""
    eng = ServingEngine(cfg, params, lanes=3, max_len=96, use_kernel=True)
    spy = _Spy(eng)
    eng.model = spy
    g = torch.Generator().manual_seed(3)
    reqs = [ServeRequest(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                              generator=g).tolist(),
                         max_new_tokens=m)
            for n, m in ((37, 5), (50, 4), (71, 6), (29, 5))]
    eng.run(reqs)
    d = dataclasses.asdict(cfg)
    out = []
    for r in reqs:
        got = torch.stack(spy.logits[tuple(r.prompt)])[:, :cfg.vocab_size]
        seq, start = r.prompt + r.output[:-1], len(r.prompt) - 1
        want = ref.served_logits(d, params, seq, start, "cpu")
        low = ref.served_logits(d, params, seq, start, "cpu", quant="bf16")
        assert got.shape == want.shape == (len(r.output), cfg.vocab_size)
        out.append((r, got.float(), want, low))
    return out


def test_serving_float32_matches_the_reference():
    """(b) Prefill, then decode through the engine (three lanes, ragged
    prompts, a lane taken over by a fourth request) equals the reference's
    full forward pass to float32 rounding."""
    cfg = smoke("float32")
    for r, got, want, _ in _serve(cfg, params_of(cfg, 4)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_serving_bf16_within_twice_the_references_bf16_error():
    """(b) The same in bf16, held to twice the reference's own bf16 error
    (its products on bf16-rounded operands, against its float32). At these
    widths (d 64, 8 experts) a one-ulp difference flips a sigmoid route,
    which moves a logit by far more than 2e-2: the smoke readings are
    0.07-1.0 for the program and 0.87-2.07 for the reference's bf16."""
    cfg = smoke("bfloat16")
    worst = ref_err = 0.0
    for _, got, want, low in _serve(cfg, params_of(cfg, 4)):
        worst = max(worst, float((got - want).abs().max()))
        ref_err = max(ref_err, float((low - want).abs().max()))
    assert 0.0 < worst <= 2 * ref_err, (worst, ref_err)


def _router_params(cfg, bias):
    g = torch.Generator().manual_seed(5)
    p = moe.moe_init(g, cfg, torch.float32)
    p["router_bias"] = bias
    return p


def test_biased_selection_differs_and_gates_stay_unbiased():
    """(c) A bias planted on one expert makes it chosen where the scores
    alone would not choose it; the gates are still the unbiased scores,
    renormalised and scaled."""
    cfg = smoke()
    m = cfg.moe
    E = m.n_experts
    x = torch.randn(16, cfg.d_model, generator=torch.Generator().manual_seed(6))
    p = _router_params(cfg, torch.zeros(E))
    s, _, plain_idx = moe.choose(p["router"], x, cfg, p["router_bias"])
    loser = int(s.mean(0).argmin())        # the least chosen on average
    bias = torch.zeros(E)
    bias[loser] = 10.0
    s2, gates, idx = moe.choose(p["router"], x, cfg, bias)
    torch.testing.assert_close(s2, s)
    assert (idx == loser).any(dim=-1).all()
    assert not (plain_idx == loser).any(dim=-1).all()
    want = s.gather(-1, idx)
    want = want / want.sum(-1, keepdim=True) * m.routed_scale
    torch.testing.assert_close(gates, want)
    assert float(gates.sum(-1).sub(m.routed_scale).abs().max()) < 1e-5


def _per_token(p, x, cfg):
    """The layer token by token: its k experts by index, plus the shared
    experts."""
    m = cfg.moe
    out = []
    for t in x:
        s = torch.sigmoid(t @ p["router"])
        _, idx = torch.sort(s + p["router_bias"], descending=True,
                            stable=True)
        idx = idx[:m.top_k]
        g = s[idx] / s[idx].sum() * m.routed_scale
        y = sum(g[j] * (F.silu(t @ p["experts"]["w_gate"][e])
                        * (t @ p["experts"]["w_up"][e]))
                @ p["experts"]["w_down"][e] for j, e in enumerate(idx))
        d = p["dense"]
        out.append(y + (F.silu(t @ d["w_gate"]) * (t @ d["w_up"]))
                   @ d["w_down"])
    return torch.stack(out)


@pytest.mark.parametrize("B,S", [(1, 37), (24, 1)])
def test_dropless_keeps_every_pair(B, S):
    """(d) Every token picks expert 0 (a planted bias), more than any
    capacity of factor 1.25 holds: the dropless layer equals a per-token
    loop, in prefill (a read of the largest load) and in decode (one
    position a row: capacity = the call's tokens)."""
    cfg = smoke()
    bias = torch.zeros(cfg.moe.n_experts)
    bias[0] = 10.0
    p = _router_params(cfg, bias)
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    for use_kernel in (False, True):
        out, aux = moe.moe_apply(p, x, cfg, use_kernel=use_kernel)
        assert aux == 0.0
        torch.testing.assert_close(
            out.reshape(B * S, -1), _per_token(p, x.reshape(B * S, -1), cfg),
            atol=1e-5, rtol=1e-5)


def test_full_size_parameter_count():
    """(e) The published config's parameters as the port lays them out:
    15,960,110,208 (the embedding and untied head over 163,840 rows, 27
    MLA layers of 13,763,072 with the latent norm, layer 0's SwiGLU of
    11,264, 26 MoE layers of 571,080,768 with router, bias and shared
    experts, 55 norms)."""
    cfg = get_config(ARCH)
    params = build_model(cfg).init(0, device="meta")
    leaves = ref.flatten(params)
    assert sum(t.numel() for t in leaves.values()) == 15_960_110_208
    specs = ref.param_specs(ref.sizes(dataclasses.asdict(cfg)))
    assert {k: (tuple(t.shape), t.dtype) for k, t in leaves.items()} == {
        k: (shape, dtype) for k, (shape, dtype, _) in specs.items()}


def test_training_is_refused():
    cfg = smoke()
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "labels": torch.zeros(1, 4, dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="dropless"):
        build_model(cfg).loss(params_of(cfg), batch)


def test_new_spans_are_emitted_and_listed():
    """(f) model.mla, mla.latent and mla.attend in prefill and decode, all
    in SPANS."""
    from torch.profiler import ProfilerActivity, profile

    cfg = smoke()
    eng = ServingEngine(cfg, params_of(cfg), lanes=2, max_len=32,
                        use_kernel=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run([ServeRequest(prompt=[3, 4, 5], max_new_tokens=3)])
    names = [e.name for e in prof.events()]
    for name in ("model.mla", "mla.latent", "mla.attend", "model.moe",
                 "model.ffn"):
        assert name in SPANS
        # 3 layers (MoE 2, FFN 1) in the prefill and each of 2 decode steps
        want = {"model.moe": 6, "model.ffn": 3}.get(name, 9)
        assert names.count(name) == want, (name, names.count(name))


class _Edges:
    """A stand-in for a capture (``decode_graph.DecodeGraphs``): records
    the edges of the spans it splits at."""

    split = decode_graph.SPLIT

    def __init__(self):
        self.edges = []

    def region(self, name):
        edges = self.edges

        class _Region:
            def __enter__(self):
                edges.append(("enter", name))

            def __exit__(self, *exc):
                edges.append(("exit", name))
        return _Region()


def test_decode_graph_splits_at_the_layer_spans():
    """A captured decode step splits where the eager step's spans
    begin and end: each mixer, each FFN or MoE block, then the head, in
    SPANS and in that order; on CPU tensors decode takes the eager path."""
    cfg = smoke()
    assert cfg.decode_graph and decode_graph.SPLIT <= set(SPANS)
    model = build_model(cfg)
    params = params_of(cfg)
    caches = model.init_caches(2, 16, "cpu")
    edges = _Edges()
    spans._capture = edges
    try:
        model.forward(params, torch.tensor([[5], [7]]), caches=caches,
                      cache_index=torch.tensor([3, 9]))
    finally:
        spans._capture = None
    names = ["model.mla", "model.ffn", "model.mla", "model.moe",
             "model.mla", "model.moe", "model.head"]
    assert edges.edges == [(e, n) for n in names for e in ("enter", "exit")]
    token, index = torch.tensor([[5], [7]]), torch.tensor([4, 10])
    got, _ = model.decode_step(params, token, caches, index)
    assert model.graphs.chain is None and model.graphs.captures == 0
    want, _ = build_model(dataclasses.replace(cfg, decode_graph=False)) \
        .decode_step(params, token, caches, index)
    torch.testing.assert_close(got, want, atol=0, rtol=0)

"""A serving decode step replayed as CUDA graphs (``models/decode_graph.py``)
against the same step run eagerly, on the card: Moonlight's smoke config
served through the engine, the profiled replay's spans, and the refusals.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decode_graph_gpu.py

Without a CUDA card every case skips.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServeRequest, ServingEngine  # noqa: E402

_PATH = (Path(__file__).resolve().parents[1] / "perfbench" / "reference"
         / "moonlight.py")


def _reference():
    spec = importlib.util.spec_from_file_location("moonlight_reference_gpu",
                                                  _PATH)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")


def _smoke(dtype, graph=True):
    return dataclasses.replace(get_smoke_config("moonlight_16b_a3b"),
                               dtype=dtype, decode_graph=graph)


class _Logits:
    """The engine's model, keeping every decode step's logits."""

    def __init__(self, model):
        self._model, self.steps = model, []

    def decode_step(self, *args):
        logits, caches = self._model.decode_step(*args)
        self.steps.append(logits)
        return logits, caches

    def __getattr__(self, name):
        return getattr(self._model, name)


def _serve(cfg, params):
    eng = ServingEngine(cfg, params, lanes=4, max_len=128, use_kernel=True)
    eng.model = spy = _Logits(eng.model)
    g = torch.Generator().manual_seed(5)
    reqs = [ServeRequest(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                              generator=g).tolist(),
                         max_new_tokens=m)
            for n, m in ((37, 9), (50, 4), (71, 12), (29, 7), (44, 6))]
    eng.run(reqs)
    return [r.output for r in reqs], torch.stack(spy.steps), spy


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replayed_decode_equals_the_eager_step(dtype):
    """Four lanes, ragged prompts, a lane taken over: every decode step's
    logits and every token as the eager step gives them."""
    _card()
    ref = _reference()
    params = ref.make_params(dataclasses.asdict(_smoke(dtype)), 11, "cuda")
    got_tokens, got, spy = _serve(_smoke(dtype), params)
    want_tokens, want, _ = _serve(_smoke(dtype, graph=False), params)
    assert spy._model.graphs["decode"].graphs
    assert got_tokens == want_tokens
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.gpu
def test_a_profiled_replay_records_the_layer_spans_with_their_kernels():
    """A replay under the profiler records each layer's span once, with
    the device work its graph launched."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    cfg = _smoke("bfloat16")
    params = _reference().make_params(dataclasses.asdict(cfg), 3, "cuda")
    model = build_model(cfg)
    caches = model.init_caches(2, 32, "cuda")
    token = torch.tensor([[5], [7]], device="cuda")
    index = torch.tensor([3, 9], device="cuda")
    model.decode_step(params, token, caches, index)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.decode_step(params, token, caches, index)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    # the host's ranges (the profiler also mirrors each on the device's
    # timeline)
    names = [e.name for e in prof.events() if e.device_type == cpu]
    for name, n in (("model.decode", 1), ("model.mla", 3), ("model.ffn", 1),
                    ("model.moe", 2), ("model.head", 1)):
        assert names.count(name) == n, (name, names.count(name))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels


@pytest.mark.gpu
def test_a_new_cache_tree_is_captured_anew():
    """Another cache tree: a new chain, which writes that tree."""
    _card()
    cfg = _smoke("float32")
    params = _reference().make_params(dataclasses.asdict(cfg), 4, "cuda")
    model = build_model(cfg)
    token = torch.tensor([[5], [7]], device="cuda")
    index = torch.tensor([3, 9], device="cuda")
    first = model.init_caches(2, 32, "cuda")
    model.decode_step(params, token, first, index)
    chain = model.graphs["decode"]
    second = model.init_caches(2, 32, "cuda")
    got, _ = model.decode_step(params, token, second, index)
    assert model.graphs["decode"] is not chain
    want, _ = build_model(dataclasses.replace(cfg, decode_graph=False)) \
        .decode_step(params, token, model.init_caches(2, 32, "cuda"), index)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.gpu
def test_a_step_with_a_counted_kernel_is_refused():
    """phi4's decode attention goes through the decode kernel, whose
    launches a replay would not count."""
    _card()
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                              decode_graph=True)
    model = build_model(cfg, decode_kernel=True)
    params = model.init(0, "cuda")
    caches = model.init_caches(2, 32, "cuda")
    with pytest.raises(ValueError, match="counted kernel"):
        model.decode_step(params, torch.tensor([[5], [7]], device="cuda"),
                          caches, torch.tensor([3, 9], device="cuda"))

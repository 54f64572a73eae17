"""A serving decode step replayed as CUDA graphs (``models/decode_graph.py``)
against the same step run eagerly, on the card: Moonlight's smoke config
served through the engine, phi4's and Gemma's with the decode kernel in
the graphs, the profiled replay's spans and kernels, and a launch count
read from the graphs' nodes against the wrappers' and the profiler's.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decode_graph_gpu.py

Without a CUDA card every case skips.
"""
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs.spans import span  # noqa: E402
from repro_torch.serving import ServeRequest, ServingEngine  # noqa: E402

_PATH = (Path(__file__).resolve().parents[1] / "perfbench" / "reference"
         / "moonlight.py")
# the decode kernel's body functions, by body (csrc/decode_attention.cu)
_BODY_KERNEL = re.compile(r"decode_attn_(mma|fma)<")


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


def _attn_layers(cfg):
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


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
    """(tokens, the decode steps' logits, the model's spy, the engine's
    summary, the decode kernel's launches by body in the run)."""
    eng = ServingEngine(cfg, params, lanes=4, max_len=128, use_kernel=True)
    eng.model = spy = _Logits(eng.model)
    g = torch.Generator().manual_seed(5)
    reqs = [ServeRequest(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                              generator=g).tolist(),
                         max_new_tokens=m)
            for n, m in ((37, 9), (50, 4), (71, 12), (29, 7), (44, 6))]
    before = ops.launches_by_body()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    launched = ops.launches_since(before).get("decode_attention", {})
    return ([r.output for r in reqs], torch.stack(spy.steps), spy, stats,
            launched)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replayed_decode_equals_the_eager_step(dtype):
    """Four lanes, ragged prompts, a lane taken over: every decode step's
    logits and every token as the eager step gives them."""
    _card()
    ref = _reference()
    params = ref.make_params(dataclasses.asdict(_smoke(dtype)), 11, "cuda")
    got_tokens, got, spy, stats, _ = _serve(_smoke(dtype), params)
    want_tokens, want, _, eager, _ = _serve(_smoke(dtype, graph=False),
                                            params)
    assert spy._model.graphs.chain.graphs
    assert stats["decode_captures"] == 1
    assert stats["decode_replays"] == stats["decode_steps"]
    assert eager["decode_captures"] == eager["decode_replays"] == 0
    assert got_tokens == want_tokens
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype,body", [
    ("phi4_mini_3_8b", "bfloat16", "mma"), ("gemma_2b", "float32", "fma")])
def test_replay_with_the_decode_kernel_equals_the_eager_step(arch, dtype,
                                                            body):
    """The decode kernel inside the graphs: tokens and logits bit-equal to
    the eager step; its launches one a layer a step in the dtype's body,
    the capture's warm-up step among them."""
    _card()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = build_model(cfg).init(7, device="cuda")
    got_tokens, got, _, stats, launched = _serve(cfg, params)
    want_tokens, want, _, eager, eager_launched = _serve(
        dataclasses.replace(cfg, decode_graph=False), params)
    assert got_tokens == want_tokens
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    attn = _attn_layers(cfg)
    assert stats["decode_captures"] == 1
    assert stats["decode_replays"] == stats["decode_steps"]
    assert eager_launched == {body: eager["decode_steps"] * attn}
    assert launched == {body: (stats["decode_steps"] + 1) * attn}


def _trace(prof, tmp_path):
    """(device kernels [(name, launch time)], host ranges [(name, start,
    end)]) of a profile, each kernel at the time of the host call that
    launched it (``cudaGraphLaunch`` for a replayed one)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in (e.get("args") or {})}
    kernels = [(e["name"], launch.get(e["args"].get("correlation")))
               for e in events if e.get("cat") == "kernel"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
              for e in events if e.get("cat") == "user_annotation"]
    return kernels, ranges


def _inside(t, ranges, name):
    return t is not None and any(n == name and a <= t <= b
                                 for n, a, b in ranges)


@pytest.mark.gpu
def test_a_replays_decode_launches_are_read_from_its_graphs(tmp_path):
    """phi4's smoke model in bf16: the decode kernel's launches a replay
    adds, read from the graphs' kernel nodes, are one a layer, as many as
    the eager step's wrapper counts and as the body kernels a profiled
    replay launches inside ``engine.decode`` and ``model.attn``."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                              dtype="bfloat16")
    model = build_model(cfg, decode_kernel=True)
    params = model.init(3, device="cuda")
    attn = _attn_layers(cfg)
    token = torch.tensor([[5], [7]], device="cuda")
    index = torch.tensor([3, 9], device="cuda")
    caches = model.init_caches(2, 32, "cuda")
    model.decode_step(params, token, caches, index)
    chain = model.graphs.chain
    launches = {"decode_attention": {"mma": attn}}
    assert chain.launches == launches

    def counted(step):
        before = ops.launches_by_body()
        step()
        torch.cuda.synchronize()
        return ops.launches_since(before)

    eager = build_model(dataclasses.replace(cfg, decode_graph=False),
                        decode_kernel=True)
    assert counted(lambda: eager.decode_step(
        params, token, model.init_caches(2, 32, "cuda"), index)) == launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("engine.decode"):
            replay = counted(lambda: model.decode_step(params, token, caches,
                                                       index))
    assert model.graphs.chain is chain and model.graphs.captures == 1
    assert replay == launches
    kernels, ranges = _trace(prof, tmp_path)
    bodies = [t for name, t in kernels if _BODY_KERNEL.search(name)]
    assert len(bodies) == attn
    assert all(_inside(t, ranges, "engine.decode")
               and _inside(t, ranges, "model.attn") for t in bodies)


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
                    ("model.moe", 2), ("model.head", 1),
                    ("model.capture", 0)):
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
    chain = model.graphs.chain
    second = model.init_caches(2, 32, "cuda")
    got, _ = model.decode_step(params, token, second, index)
    assert model.graphs.chain is not chain
    assert (model.graphs.captures, model.graphs.replays) == (2, 2)
    want, _ = build_model(dataclasses.replace(cfg, decode_graph=False)) \
        .decode_step(params, token, model.init_caches(2, 32, "cuda"), index)
    torch.testing.assert_close(got, want, atol=0, rtol=0)

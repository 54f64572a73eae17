"""Which decode steps replay CUDA graphs (``models/decode_graph.py``), on
the CPU: the switch's default and the benchmark's phi4 configuration, the
eager steps of CPU tensors and of DTensors on a mesh, where a capture of
phi4's step splits, the capture's span, and the launch counts a replay
adds. The capture itself runs on the card only
(``tests/test_torch_decode_graph_gpu.py``)."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.build import KernelLibrary
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import build_model, decode_graph
from repro_torch.obs import spans
from repro_torch.obs.spans import SPANS
from repro_torch.serving import ServeRequest, ServingEngine

PHI4 = (Path(__file__).resolve().parents[1] / "perfbench" / "configs"
        / "phi4_mini_3_8b.json")


def _no_replay(*args):
    raise AssertionError("an eager decode step was replayed")


def test_decode_graph_is_on_by_default():
    """Every configuration replays its decode steps unless it turns them
    off, the benchmark's phi4 among them (its file names no switch)."""
    assert ModelConfig().decode_graph is True
    model = json.loads(PHI4.read_text())["model"]
    assert "decode_graph" not in model
    assert ModelConfig(**model).decode_graph is True
    assert get_smoke_config("moonlight_16b_a3b").decode_graph is True


def test_model_capture_is_a_span():
    assert "model.capture" in SPANS
    assert not {"model.capture"} & decode_graph.SPLIT


def _phi4(dtype="float32"):
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                              dtype=dtype)
    return cfg, build_model(cfg, decode_kernel=True).init(0, device="cpu")


def test_cpu_tensors_take_the_eager_step(monkeypatch):
    """CPU tensors with per-lane positions: the eager step, equal to the
    one with the switch off, and nothing captured."""
    monkeypatch.setattr(decode_graph, "decode", _no_replay)
    cfg, params = _phi4()
    token, index = torch.tensor([[5], [7]]), torch.tensor([4, 10])
    model = build_model(cfg, decode_kernel=True)
    got, _ = model.decode_step(params, token,
                               model.init_caches(2, 16, "cpu"), index)
    off = build_model(dataclasses.replace(cfg, decode_graph=False),
                      decode_kernel=True)
    want, _ = off.decode_step(params, token, off.init_caches(2, 16, "cpu"),
                              index)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    graphs = model.graphs
    assert (graphs.chain, graphs.captures, graphs.replays) == (None, 0, 0)


@pytest.fixture
def host_mesh():
    mesh_lib.init_group("gloo", 1)
    try:
        yield mesh_lib.make_host_mesh("cpu")
    finally:
        mesh_lib.destroy_group()


def test_dtensor_inputs_take_the_eager_step(host_mesh, monkeypatch):
    """DTensors on a mesh, with per-lane positions: the eager step, equal
    to the one with the switch off."""
    monkeypatch.setattr(decode_graph, "decode", _no_replay)
    cfg, params = _phi4()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    token, index = torch.tensor([[5], [7]]), torch.tensor([15, 12])
    got = []
    for c in (cfg, dataclasses.replace(cfg, decode_graph=False)):
        _, caches = build_prefill_step(c, device="cpu", mesh=host_mesh)(
            params, {"tokens": toks})
        logits, _ = build_decode_step(c, mesh=host_mesh)(params, token,
                                                          caches, index)
        assert type(logits) is not torch.Tensor       # a DTensor
        got.append(logits.to_local())
    torch.testing.assert_close(got[0], got[1], atol=0, rtol=0)


def test_the_engine_reports_no_capture_on_the_cpu():
    cfg, params = _phi4()
    stats = ServingEngine(cfg, params, lanes=2, max_len=32).run(
        [ServeRequest(prompt=[3, 4, 5], max_new_tokens=3),
         ServeRequest(prompt=[6, 7], max_new_tokens=2)])
    assert stats["decode_steps"] > 0
    assert (stats["decode_captures"], stats["decode_replays"]) == (0, 0)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_phi4_capture_splits_at_each_attention_and_ffn(dtype):
    """phi4's step, the decode kernel's path (its plain version here),
    splits once at each ``model.attn`` and ``model.ffn`` and at the head,
    in layer order."""
    cfg, params = _phi4(dtype)
    model = build_model(cfg, decode_kernel=True)
    caches = model.init_caches(2, 16, "cpu")
    edges = _Edges()
    spans._capture = edges
    try:
        model.forward(params, torch.tensor([[5], [7]]), caches=caches,
                      cache_index=torch.tensor([3, 9]), use_kernel=True)
    finally:
        spans._capture = None
    names = ["model.attn", "model.ffn"] * cfg.n_layers + ["model.head"]
    assert edges.edges == [(e, n) for n in names for e in ("enter", "exit")]


class _Counted(KernelLibrary):
    name = "counted"


def test_a_replays_launches_are_added_to_the_kernels_counts(monkeypatch):
    """What a graph holds is added once a replay, and taken back (a body
    left at none is dropped)."""
    kernel = _Counted()
    monkeypatch.setitem(ops.KERNELS, "counted", kernel)
    kernel._count("a")
    ops.count_launches({"counted": {"a": 2, "b": 3}})
    assert kernel.launches_by_body == {"a": 3, "b": 3}
    ops.count_launches({"counted": {"b": 3}}, -1)
    assert kernel.launches_by_body == {"a": 3}
    assert kernel.launches == 3
    before = ops.launches_by_body()
    assert before["counted"] == {"a": 3}
    ops.count_launches({"counted": {"a": 1, "c": 2}})
    assert ops.launches_since(before) == {"counted": {"a": 1, "c": 2}}


def test_a_library_not_loaded_reads_no_launches_from_a_graph(monkeypatch):
    """A library never built has launched nothing: no graph holds its
    kernels, and it is not asked (no CUDA runtime is touched)."""
    monkeypatch.setitem(ops.KERNELS, "counted", _Counted())
    assert all(k._lib is None for k in ops.KERNELS.values())
    assert ops.graph_launches(0) == {}

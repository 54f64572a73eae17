"""The port's spans (``repro_torch.obs.spans``) on the CPU, at the smoke
configurations: where the serving engine, the model's blocks and the MoE
layer record them under torch.profiler, that every name they emit is in
``SPANS``, that profiling changes no output, token or gradient, and that an
unprofiled run enters no ``record_function``."""
import collections
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import RunConfig, get_smoke_config
from repro_torch.launch.steps import (STEP_RANGES, build_train_step,
                                      init_train_state)
from repro_torch.models import build_model
from repro_torch.models.transformer import _MIXER_SPAN
from repro_torch.obs import spans
from repro_torch.obs.spans import SPANS, span
from repro_torch.serving import ServeRequest, ServingEngine
from repro_torch.tree import leaves

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
ENGINE = ("engine.admit", "engine.prefill", "engine.scatter",
          "engine.decode", "engine.sample")


def _profiled(fn):
    """fn() under torch.profiler (CPU activity); returns (its result, the
    host ranges the profile recorded as (name, start, end) by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CPU
                     and e.is_user_annotation), key=lambda r: r[1])
    return out, ranges


class _CountingModel:
    """A model whose prefill and decode calls are counted."""

    def __init__(self, model):
        self._model, self.calls = model, collections.Counter()

    def prefill(self, *args, **kw):
        self.calls["prefill"] += 1
        return self._model.prefill(*args, **kw)

    def decode_step(self, *args, **kw):
        self.calls["decode"] += 1
        return self._model.decode_step(*args, **kw)

    def __getattr__(self, name):
        return getattr(self._model, name)


def _serve(arch, profiled):
    """Seven requests of mixed lengths on three lanes (one stopping at its
    prefill token); returns (outputs, the model's calls by kind, decode
    steps, the configuration, the ranges or None)."""
    cfg = get_smoke_config(arch)
    params = build_model(cfg).init(0, device="cpu")
    eng = ServingEngine(cfg, params, lanes=3, max_len=48)
    eng.model = _CountingModel(eng.model)
    rng = np.random.default_rng(11)
    reqs = [ServeRequest(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                         max_new_tokens=k)
            for n, k in ((7, 5), (3, 4), (12, 1), (5, 6), (9, 3), (4, 5),
                         (16, 2))]
    if profiled:
        _, ranges = _profiled(lambda: eng.run(reqs))
    else:
        eng.run(reqs)
        ranges = None
    return ([r.output for r in reqs], eng.model.calls, eng.steps, cfg,
            ranges)


@pytest.fixture(scope="module")
def served():
    return {arch: (_serve(arch, profiled=False), _serve(arch, profiled=True))
            for arch in ("phi4_mini_3_8b", "granite_moe_1b_a400m")}


def _count(ranges, name):
    return sum(1 for n, _, _ in ranges if n == name)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "granite_moe_1b_a400m"])
def test_engine_spans_per_request_and_per_decode(served, arch):
    _, (outputs, calls, steps, cfg, ranges) = served[arch]
    admitted = len(outputs)
    assert calls["prefill"] == admitted and calls["decode"] == steps > 0
    assert _count(ranges, "engine.prefill") == admitted
    assert _count(ranges, "engine.scatter") == admitted
    assert _count(ranges, "engine.decode") == calls["decode"]
    # one argmax a prefill and one a decode step
    assert _count(ranges, "engine.sample") == admitted + steps
    assert _count(ranges, "model.prefill") == admitted
    assert _count(ranges, "model.decode") == steps
    # every step admits once; every engine span sits inside a step
    step_ranges = [(a, b) for n, a, b in ranges if n == "engine.step"]
    assert _count(ranges, "engine.admit") == len(step_ranges) >= steps
    for name, a, b in ranges:
        if name in ENGINE:
            assert any(s <= a and b <= e for s, e in step_ranges), name
    # a prefill's scatter and argmax follow it, in FIFO order
    order = [n for n, _, _ in ranges if n in ("engine.prefill",
                                              "engine.scatter")]
    assert order == ["engine.prefill", "engine.scatter"] * admitted


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "granite_moe_1b_a400m"])
def test_model_spans_per_layer(served, arch):
    _, (outputs, calls, steps, cfg, ranges) = served[arch]
    forwards = calls["prefill"] + calls["decode"]
    assert _count(ranges, "model.attn") == cfg.n_layers * forwards
    assert _count(ranges, "model.head") == forwards
    ffn = "model.moe" if cfg.moe.enabled else "model.ffn"
    other = "model.ffn" if ffn == "model.moe" else "model.moe"
    assert _count(ranges, ffn) == cfg.n_layers * forwards
    assert _count(ranges, other) == 0
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert _count(ranges, name) == (cfg.n_layers * forwards
                                        if ffn == "model.moe" else 0)
    assert {n for n, _, _ in ranges} <= set(SPANS)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "granite_moe_1b_a400m"])
def test_profiled_engine_serves_the_same_tokens(served, arch):
    (plain, _, plain_steps, _, _), (traced, _, steps, _, _) = served[arch]
    assert traced == plain and steps == plain_steps
    assert [len(o) for o in traced] == [5, 4, 1, 6, 3, 5, 2]


def _granite_step():
    cfg = dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"),
                              dtype="float32")
    assert cfg.remat == "block"
    run = RunConfig(model=cfg, seq_len=32, global_batch=4, warmup_steps=0,
                    total_steps=10)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (4, 33), generator=g)
    batch = {"tokens": tokens[:, :-1].to(torch.int32),
             "labels": tokens[:, 1:].to(torch.int32)}
    return cfg, run, batch


def test_profiled_train_step_records_the_recompute_and_changes_nothing():
    cfg, run, batch = _granite_step()
    step = build_train_step(cfg, run=run, device="cpu")
    states = [init_train_state(cfg, run, device="cpu") for _ in range(2)]
    plain, plain_metrics = step(states[0], batch)
    (traced, metrics), ranges = _profiled(lambda: step(states[1], batch))
    for name in STEP_RANGES:
        assert _count(ranges, name) == 1
    # block remat runs each block's forward twice: in the forward pass and
    # in the backward pass's recompute
    for name in ("model.attn", "model.moe", "moe.route", "moe.dispatch",
                 "moe.experts", "moe.combine"):
        assert _count(ranges, name) == 2 * cfg.n_layers, name
    assert _count(ranges, "model.head") == 1
    assert {n for n, _, _ in ranges} <= set(SPANS)
    # the same gradients (AdamW's first moment after one step is (1 - b1)
    # times the gradient), moments and updated weights, bit for bit
    for a, b in zip(leaves(plain), leaves(traced)):
        assert torch.equal(a, b)
    for key in ("ce", "aux", "loss", "grad_norm"):
        assert torch.equal(plain_metrics[key], metrics[key]), key


def test_unprofiled_spans_enter_no_record_function(monkeypatch):
    entered = []
    real = spans.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(spans, "record_function", counting)
    cfg = get_smoke_config("granite_moe_1b_a400m")
    params = build_model(cfg).init(0, device="cpu")
    eng = ServingEngine(cfg, params, lanes=2, max_len=32)
    eng.run([ServeRequest(prompt=[1, 2, 3], max_new_tokens=3)
             for _ in range(3)])
    with span("engine.step"):
        pass
    assert entered == []
    # the same calls under the profiler enter it, span by span
    _, ranges = _profiled(lambda: eng.run(
        [ServeRequest(prompt=[4, 5], max_new_tokens=2)]))
    assert len(entered) == len(ranges) > 0


def test_every_range_of_the_port_is_a_span_in_spans():
    """No ``record_function`` outside ``obs/spans.py``; every literal span
    name, and every mixer kind's, is in SPANS; SPANS has no duplicate."""
    assert len(set(SPANS)) == len(SPANS)
    assert set(_MIXER_SPAN.values()) <= set(SPANS)
    names = set()
    for path in SRC.rglob("*.py"):
        text = path.read_text()
        if path != SRC / "obs" / "spans.py":
            assert not re.search(r"record_function\s*\(|import[^\n]*"
                                 r"record_function", text), path
        names |= set(re.findall(r"\bspan\(\"([^\"]+)\"\)", text))
    assert names and names <= set(SPANS), names - set(SPANS)
    assert {"engine.step", "moe.combine", "model.head"} <= names

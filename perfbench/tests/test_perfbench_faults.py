"""``correct`` comes out false where it must, at a size a test run holds.

The control: the reference put in the program's place and computed one
precision below the configuration's fails a cell's limits. The faults: a run of the harness past its look
for a card, with the timed path broken underneath (the program patched),
reads ``correct`` false, once for each fault a cell can have: a step that
returns its state unchanged; half of the batch left out; a token altered
where it is produced. (One card: no exchange between chips to leave out.)
"""
import time

import pytest
import torch

from conftest import SERVE, TRAIN, overrides
from perfbench import registry, run


def run_small(cell, seed=77, seconds=3.0):
    """A run at test size; the window holds some tens of finished
    requests even on a loaded host."""
    result, _ = run.run_cell(cell, seed, seconds, False, device="cpu",
                             t_start=time.perf_counter(),
                             overrides=overrides(cell))
    return result


def test_sound_runs_are_correct():
    assert run_small(SERVE)["correct"] and run_small(TRAIN)["correct"]


def test_serving_control_fails():
    ctx, _, limits = run.make_context(SERVE, 5, 1.0, False, "cpu",
                                      time.perf_counter(), overrides(SERVE))
    ctx.control = ctx.ref.control_for(ctx.cfg)
    rec = registry.driver("serve").run(ctx)
    assert rec.checks["served_gap"] <= limits["served_gap"]["limit"]
    assert rec.control["served_gap"] > limits["served_gap"]["limit"]


def test_training_control_fails():
    from perfbench import calibrate

    ctx, _, limits = run.make_context(TRAIN, 5, 1.0, False, "cpu",
                                      time.perf_counter(), overrides(TRAIN))
    control, faults = calibrate._train_controls(ctx)
    assert any(control[n] > limits[n]["limit"] for n in limits)
    half = faults["half_batch"]
    assert any(half[n] > limits[n]["limit"] for n in limits)


@pytest.fixture
def model_cls():
    from repro_torch.models.model import Model

    return Model


def test_served_token_altered_where_produced(monkeypatch, model_cls):
    orig = model_cls.decode_step

    def altered(self, *a, **k):
        logits, caches = orig(self, *a, **k)
        return logits.roll(1, dims=-1), caches

    monkeypatch.setattr(model_cls, "decode_step", altered)
    assert run_small(SERVE)["correct"] is False


def test_engine_step_returns_its_state_unchanged(monkeypatch):
    """Once the window opens, each step() returns at once: nothing is
    admitted or decoded, and the window's requests never get a token."""
    from repro_torch.serving.engine import ServingEngine

    clients = registry.driver("serve")._Clients
    send, step = clients.send, ServingEngine.step
    window = {"open": False}

    def send_marked(self, now, in_window):
        window["open"] |= in_window
        return send(self, now, in_window)

    def frozen(self):
        return 0 if window["open"] else step(self)

    monkeypatch.setattr(clients, "send", send_marked)
    monkeypatch.setattr(ServingEngine, "step", frozen)
    ov = overrides(SERVE)
    ov["mix"]["follow_s"] = 0.5
    result, _ = run.run_cell(SERVE, 77, 1.0, False, device="cpu",
                             t_start=time.perf_counter(), overrides=ov)
    assert result["failed"] > 0 and result["correct"] is False


def test_decode_leaves_out_half_the_lanes(monkeypatch, model_cls):
    orig = model_cls.decode_step

    def half(self, params, token, caches, cache_index):
        logits, caches = orig(self, params, token, caches, cache_index)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits, caches

    monkeypatch.setattr(model_cls, "decode_step", half)
    assert run_small(SERVE)["correct"] is False


def _patch_train_step(monkeypatch, wrap):
    from repro_torch.launch import steps

    orig = steps.build_train_step

    def build(*a, **k):
        return wrap(orig(*a, **k))

    monkeypatch.setattr(steps, "build_train_step", build)


def test_train_step_returns_its_state_unchanged(monkeypatch):
    from repro_torch.tree import leaves

    def wrap(step):
        def frozen(state, batch):
            saved = [t.clone() for t in leaves(state)]
            new, metrics = step(state, batch)
            with torch.no_grad():
                for t, s in zip(leaves(new), saved):
                    t.copy_(s)
            return new, metrics
        return frozen

    _patch_train_step(monkeypatch, wrap)
    assert run_small(TRAIN)["correct"] is False


def test_train_step_leaves_out_half_the_batch(monkeypatch):
    def wrap(step):
        def half(state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half

    _patch_train_step(monkeypatch, wrap)
    assert run_small(TRAIN)["correct"] is False

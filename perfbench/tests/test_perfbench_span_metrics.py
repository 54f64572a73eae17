"""The six readers of the program's spans, on synthetic traces built as
``test_perfbench_metrics.py`` builds them, each against a hand count:
nested and back-to-back spans, operations launched inside, between and
outside them, and nothing read from a trace without the spans (the trace
of a program that records none)."""
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import registry
from perfbench.trace import Trace

NAMES = ("admit_wait_p95_ms", "scatter_ms", "decode_ms", "decode_host_ms",
         "attn_fwd_ms", "moe_dispatch_ms")


def metric(name):
    return registry.metric(name).read


def run_of(trace, kind="serve"):
    return SimpleNamespace(kind=kind, trace=trace)


def serve_trace():
    """Three back-to-back steps (us): the first admits three prompts, the
    second none, the third one; each admission is a prefill, a scatter and
    a sample, nested in ``engine.admit``; each step ends in a decode."""
    r = [("bench.window", 0.0, 10_000.0)]
    # step 1: [0, 3000)
    r += [("engine.step", 0.0, 3000.0), ("engine.admit", 10.0, 2500.0),
          ("engine.prefill", 20.0, 500.0), ("bench.prefill", 25.0, 495.0),
          ("engine.scatter", 500.0, 600.0), ("engine.sample", 600.0, 620.0),
          ("engine.prefill", 620.0, 1400.0),
          ("engine.scatter", 1400.0, 1500.0), ("engine.sample", 1500.0, 1520.0),
          ("engine.prefill", 1520.0, 2300.0),
          ("engine.scatter", 2300.0, 2400.0), ("engine.sample", 2400.0, 2420.0),
          ("engine.decode", 2500.0, 2900.0), ("engine.sample", 2900.0, 2990.0)]
    # step 2: [3000, 4000), decode only
    r += [("engine.step", 3000.0, 4000.0), ("engine.admit", 3001.0, 3002.0),
          ("engine.decode", 3010.0, 3610.0), ("engine.sample", 3610.0, 3700.0)]
    # step 3: [4000, 6000), one prompt
    r += [("engine.step", 4000.0, 6000.0), ("engine.admit", 4005.0, 5500.0),
          ("engine.prefill", 4050.0, 5300.0),
          ("engine.scatter", 5300.0, 5400.0), ("engine.sample", 5400.0, 5420.0),
          ("engine.decode", 5500.0, 5700.0), ("engine.sample", 5700.0, 5800.0)]
    ops = [("copy", 700.0, 740.0, 510.0),        # scatter 1: 40 us
           ("copy", 1600.0, 1630.0, 1450.0),     # scatter 2: 30
           ("copy", 2500.0, 2550.0, 2310.0),     # scatter 3: 50
           ("copy", 5450.0, 5470.0, 5399.0),     # scatter 4: 20
           ("gemm", 100.0, 400.0, 30.0),         # prefill: not scatter
           ("attn", 2600.0, 3100.0, 2550.0),     # decode 1: 500
           ("norm", 3100.0, 3150.0, 2800.0),     # decode 1: 50
           ("attn", 3200.0, 3700.0, 3100.0),     # decode 2: 500
           ("attn", 5800.0, 5900.0, 5600.0),     # decode 3: 100
           ("argmax", 5900.0, 5910.0, 5750.0),   # sample: neither
           ("memset", 0.0, 1.0, None)]           # no launch: placed nowhere
    return Trace((0.0, 10_000.0), ops, r, [])


def test_admit_wait_p95_is_over_every_prefill_from_its_step():
    waits_ms = [20e-3, 620e-3, 1520e-3, 50e-3]   # prefill start - step start
    assert metric("admit_wait_p95_ms")(run_of(serve_trace())) == \
        pytest.approx(float(np.percentile(waits_ms, 95)))


def test_admit_wait_leaves_out_prefills_outside_the_window_or_a_step():
    t = serve_trace()
    t.ranges.append(("engine.prefill", 12_000.0, 12_500.0))  # after window
    t.ranges.append(("engine.prefill", 3500.0, 4500.0))      # crosses steps
    waits_ms = [20e-3, 620e-3, 1520e-3, 50e-3]
    assert metric("admit_wait_p95_ms")(run_of(t)) == \
        pytest.approx(float(np.percentile(waits_ms, 95)))


def test_scatter_ms_places_copies_by_their_launch():
    assert metric("scatter_ms")(run_of(serve_trace())) == \
        pytest.approx((40 + 30 + 50 + 20) / 1e3 / 4)


def test_decode_ms_and_host_ms():
    run = run_of(serve_trace())
    assert metric("decode_ms")(run) == pytest.approx(
        (500 + 50 + 500 + 100) / 1e3 / 3)
    assert metric("decode_host_ms")(run) == pytest.approx(
        (400 + 600 + 200) / 1e3 / 3)


def train_trace():
    """Two steps (us). Each: a forward with two layers, each an attention
    mixer then an MoE block holding route, dispatch, experts and combine;
    a backward whose recompute repeats the first layer's spans; AdamW."""
    r = [("bench.window", 0.0, 20_000.0)]
    ops = []
    for base in (0.0, 10_000.0):
        r += [("train_step.forward", base, base + 4000.0),
              ("train_step.backward", base + 4000.0, base + 9000.0),
              ("train_step.optimizer", base + 9000.0, base + 9900.0)]
        for start in (base + 100.0, base + 2000.0, base + 5000.0):
            r += [("model.attn", start, start + 500.0),
                  ("model.moe", start + 600.0, start + 1400.0),
                  ("moe.route", start + 610.0, start + 700.0),
                  ("moe.dispatch", start + 700.0, start + 900.0),
                  ("moe.experts", start + 900.0, start + 1300.0),
                  ("moe.combine", start + 1300.0, start + 1390.0)]
            ops += [("attn", start + 50.0, start + 250.0, start + 10.0),
                    ("norm", start + 550.0, start + 560.0, start + 520.0),
                    ("topk", start + 620.0, start + 630.0, start + 650.0),
                    ("onehot", start + 720.0, start + 750.0, start + 800.0),
                    ("bmm", start + 950.0, start + 1250.0, start + 1000.0),
                    ("einsum", start + 1320.0, start + 1325.0,
                     start + 1389.0)]
        ops += [("attn_grad", base + 6000.0, base + 6300.0, base + 5950.0),
                ("adam", base + 9100.0, base + 9500.0, base + 9050.0)]
    return Trace((0.0, 20_000.0), ops, r, [])


def test_attn_fwd_ms_counts_forward_and_recompute_per_step():
    # three mixer spans a step (two forward, one recompute), 200 us each;
    # the backward's own attention gradient is outside every mixer span
    run = run_of(train_trace(), kind="train")
    assert metric("attn_fwd_ms")(run) == pytest.approx(3 * 200 / 1e3)


def test_moe_dispatch_ms_leaves_out_the_expert_products():
    run = run_of(train_trace(), kind="train")
    assert metric("moe_dispatch_ms")(run) == pytest.approx(
        3 * (10 + 30 + 5) / 1e3)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_is_read_without_the_spans(name):
    # the parent's traces: the benchmark's ranges and kernels, no spans
    bare = Trace((0.0, 1000.0),
                 [("copy", 10.0, 20.0, 5.0), ("gemm", 30.0, 90.0, 25.0)],
                 [("bench.window", 0.0, 1000.0), ("bench.step", 0.0, 500.0),
                  ("bench.prefill", 1.0, 400.0),
                  ("train_step.forward", 0.0, 300.0)], [])
    assert metric(name)(run_of(bare)) is None
    assert metric(name)(run_of(None)) is None
    assert metric(name)(SimpleNamespace(kind="serve")) is None


@pytest.mark.parametrize("name", ["scatter_ms", "decode_ms", "attn_fwd_ms",
                                  "moe_dispatch_ms"])
def test_device_readers_need_a_device_operation(name):
    # the spans of a CPU run: host ranges, no device operation
    t = serve_trace()
    t2 = train_trace()
    ranges = t.ranges + t2.ranges
    assert metric(name)(run_of(Trace((0.0, 20_000.0), [], ranges, []))) \
        is None


def test_each_reader_is_a_per_layer_metric_of_its_cell():
    bench = registry.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {"admit_wait_p95_ms": "phi4-serve-longdoc",
             "scatter_ms": "phi4-serve-longdoc",
             "decode_ms": "phi4-serve-longdoc",
             "decode_host_ms": "phi4-serve-longdoc",
             "attn_fwd_ms": "granite-train-moe",
             "moe_dispatch_ms": "granite-train-moe"}
    for name, cell in cells.items():
        assert entries[name]["workloads"] == [cell]
        assert entries[name]["unit"] == "ms"
        assert entries[name]["better"] == "lower"

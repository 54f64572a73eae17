"""The metric arithmetic on synthetic records: tails over every sample,
rates over the window, the idle share from overlapping intervals, and
each per-layer reader."""
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import flops, peaks, registry, stats
from perfbench.trace import Trace

PHI = registry.config("phi4_mini_3_8b", registry.benchmark())["model"]


def metric(name):
    return registry.metric(name).read


def serve_run(**kw):
    base = dict(kind="serve", cfg=PHI, mix={}, setup_s=12.5,
                window=(100.0, 110.0), tokens=0, requests=[], token_times=[],
                steps=[], prefills=[], trace=None)
    base.update(kw)
    return SimpleNamespace(**base)


def test_p95_is_over_every_sample():
    xs = list(range(1, 101))                      # 1 .. 100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([], 95) is None
    assert stats.percentile([3.0], 95) == 3.0


def test_rate_is_work_over_window():
    assert stats.rate(300, 10.0) == 30.0
    assert stats.rate(1, 0.0) is None


def test_union_and_idle_share_of_overlapping_intervals():
    ivs = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert stats.union(ivs) == [(0, 3), (5, 6), (9, 12)]
    assert stats.covered(ivs, 0, 10) == 5
    assert stats.gaps(ivs, 0, 10) == [(3, 5), (6, 9)]
    ops = [("k", a * 1e6, b * 1e6, None) for a, b in ivs]
    t = Trace((0.0, 10e6), ops, [], [])
    assert t.busy_s == pytest.approx(5.0) and t.window_s == 10.0
    run = serve_run(trace=t)
    assert metric("device_idle.serve")(run) == pytest.approx(50.0)
    assert metric("device_idle.train")(run) is None


def test_serve_end_to_end_metrics():
    # 3 requests sent in the window; first tokens after 0.1, 0.2, 0.5 s
    reqs = [SimpleNamespace(send=101.0 + i, times=[101.0 + i + d, 102.5 + i])
            for i, d in enumerate((0.1, 0.2, 0.5))]
    reqs.append(SimpleNamespace(send=108.0, times=[]))          # failed
    token_times = [r.times for r in reqs] + [[99.0, 100.5, 109.0, 111.0]]
    run = serve_run(tokens=420, requests=reqs, token_times=token_times)
    assert metric("serve_tok_s")(run) == pytest.approx(42.0)
    ttft = np.percentile([0.1, 0.2, 0.5], 95) * 1e3
    assert metric("ttft_p95_ms")(run) == pytest.approx(ttft)
    # gaps ending in (100, 110]: 1.4, 1.3, 1.0 (requests), 1.5, 8.5
    gaps = [1.4, 1.3, 1.0, 1.5, 8.5]
    assert metric("itl_p95_ms")(run) == pytest.approx(
        np.percentile(gaps, 95) * 1e3)
    assert metric("setup_s")(run) == 12.5
    assert metric("train_tok_s")(run) is None


def test_train_end_to_end_and_mfu():
    cfg = registry.config("granite_moe_1b_a400m", registry.benchmark())["model"]
    steps = [(100.0 + i, 101.0 + i) for i in range(10)]
    run = SimpleNamespace(kind="train", cfg=cfg, mix={"batch": 8, "seq": 2048},
                          window=(100.0, 110.0), steps=steps,
                          tokens=10 * 16384, setup_s=3.0, trace=None)
    assert metric("train_tok_s")(run) == pytest.approx(16384.0)
    f = flops.train_flops(cfg, 8, 2048)["flops"]
    assert metric("train_mfu")(run) == pytest.approx(
        100 * f * 10 / (10.0 * peaks.BF16_FLOPS))
    assert metric("optimizer_ms")(run) is None


def test_prefill_readers():
    spans = [(0.0, 0.05, 1024), (1.0, 1.2, 4096)]
    run = serve_run(prefills=spans)
    assert metric("prefill_ms_per_ktok")(run) == pytest.approx(
        250.0 / 5120 * 1e3)
    work = flops.prefill_flops(PHI, 1024) + flops.prefill_flops(PHI, 4096)
    assert metric("prefill_mfu")(run) == pytest.approx(
        100 * work / (0.25 * peaks.BF16_FLOPS))
    assert metric("prefill_mfu")(serve_run()) is None


def test_k1_roofline_reads_the_trace():
    L = PHI["n_layers"]
    spans = [(0.0, 0.1, 1000), (0.2, 0.3, 2000)]
    ops = [("void flash_fwd_wgmma<128>(CUtensorMap)", 10.0 * i,
            10.0 * i + 20.0, None) for i in range(2 * L)]
    ops.append(("ampere_bf16_gemm", 0.0, 5.0, None))
    t = Trace((0.0, 1e6), ops, [], [])
    run = serve_run(prefills=spans, trace=t)
    bound = L * sum(flops.k1_counts(s, s, 24, 8, 128)["bound_s"]
                    for s in (1000, 2000))
    assert metric("k1_roofline")(run) == pytest.approx(
        100 * bound / (2 * L * 20e-6))
    # launches that are not one a layer a prefill: nothing to read
    t2 = Trace((0.0, 1e6), ops[:5], [], [])
    assert metric("k1_roofline")(serve_run(prefills=spans, trace=t2)) is None


def test_step_self_time():
    steps = [(0.0, 0.3), (0.3, 0.4), (0.4, 0.6)]
    spans = [(0.05, 0.2, 100)]
    run = serve_run(steps=steps, prefills=spans,
                    trace=Trace((0.0, 1.0), [], [], []))
    assert metric("step_self_ms")(run) == pytest.approx(
        (0.6 - 0.15) * 1e3 / 3)


def test_optimizer_ms_places_kernels_by_their_launch():
    ranges = [("train_step.optimizer", 100.0, 200.0),
              ("train_step.optimizer", 1100.0, 1200.0),
              ("train_step.backward", 0.0, 100.0)]
    ops = [("adam_a", 150.0, 450.0, 120.0),     # launched inside: counts
           ("adam_b", 1300.0, 1500.0, 1190.0),  # inside
           ("bwd", 160.0, 170.0, 50.0),         # launched in backward
           ("memcpy", 0.0, 1.0, None)]
    t = Trace((0.0, 2000.0), ops, ranges, [])
    run = SimpleNamespace(kind="train", trace=t)
    assert metric("optimizer_ms")(run) == pytest.approx((300 + 200) / 1e3 / 2)


def test_breakdown_names_gaps_by_host_activity():
    ops = [("k1", 0.0, 10.0, None), ("k2", 50.0, 60.0, None)]
    ranges = [("bench.window", 0.0, 100.0), ("bench.decode", 5.0, 70.0)]
    host = [("aten::mm", 8.0, 30.0, 1), ("aten::add", 12.0, 14.0, 1)]
    t = Trace((0.0, 100.0), ops, ranges, host, main_tid=1)
    assert t.top_ops() == [["k1", 1e-5], ["k2", 1e-5]]
    gaps = t.idle_gaps()
    assert gaps[0] == ["bench.decode: aten::mm", 40e-6]
    assert gaps[1] == ["bench.decode: python", 40e-6]


def test_step_summary_splits_steps_by_admission():
    from perfbench.drivers import serve

    steps = [(0.0, 0.3), (0.3, 0.4), (0.4, 0.9), (0.9, 1.0)]
    admits = [(2, 5000), (0, 0), (1, 8000), (0, 0)]
    s = serve._step_summary(steps, admits)
    assert (s["prefill_steps"], s["decode_steps"]) == (2, 2)
    assert s["prefill_steps_s"] == pytest.approx(0.8)
    assert s["decode_steps_s"] == pytest.approx(0.2)
    assert (s["prompts"], s["prompt_tokens"]) == (3, 13000)
    assert s["slowest_step_s"] == pytest.approx(0.5)

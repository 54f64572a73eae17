"""decode_attn_ms on synthetic traces built as
``test_perfbench_span_metrics.py`` builds them: the decode kernel's
functions launched in ``engine.decode`` spans, per span, against a hand
count; nothing read from a trace whose decode launches no such function
(the program before the kernel) or that has no spans."""
from types import SimpleNamespace

import pytest

from perfbench import registry
from perfbench.trace import Trace

KERNEL = "void (anonymous namespace)::decode_attn_mma<128>(bf16 const*)"
MERGE = "void (anonymous namespace)::decode_attn_merge<bf16>(float const*)"


def read(trace):
    return registry.metric("decode_attn_ms").read(
        SimpleNamespace(kind="serve", trace=trace))


def decode_trace(kernel=KERNEL, merge=MERGE):
    """Two steps (us), each a decode span holding two layers' attention
    (the kernel and its merge) and a GEMM; a prefill between them launches
    the same kernel names, which are not a decode's."""
    r = [("bench.window", 0.0, 10_000.0),
         ("engine.decode", 100.0, 900.0), ("model.attn", 120.0, 300.0),
         ("model.attn", 400.0, 600.0),
         ("engine.prefill", 1000.0, 2000.0),
         ("engine.decode", 3000.0, 3900.0), ("model.attn", 3100.0, 3300.0),
         ("model.attn", 3400.0, 3600.0)]
    ops = [(kernel, 200.0, 260.0, 130.0), (merge, 260.0, 265.0, 140.0),
           ("gemm", 270.0, 300.0, 150.0),
           (kernel, 300.0, 350.0, 410.0), (merge, 350.0, 354.0, 420.0),
           (kernel, 1100.0, 1900.0, 1050.0),            # in a prefill
           (kernel, 3200.0, 3270.0, 3110.0), (merge, 3270.0, 3276.0, 3120.0),
           (kernel, 3300.0, 3340.0, 3410.0), (merge, 3340.0, 3343.0, 3420.0),
           ("gemm", 3350.0, 3400.0, 3430.0)]
    return Trace((0.0, 10_000.0), ops, r, [])


def test_counts_the_kernel_and_its_merge_per_decode_span():
    assert read(decode_trace()) == pytest.approx(
        (60 + 5 + 50 + 4 + 70 + 6 + 40 + 3) / 1e3 / 2)


def test_nothing_is_read_without_the_kernel_or_the_spans():
    # the parent's decode: plain PyTorch, no decode_attn_ function
    assert read(decode_trace(kernel="elementwise_kernel<128, 4>",
                             merge="bmm")) is None
    bare = decode_trace()
    bare.ranges[:] = [r for r in bare.ranges if r[0] == "bench.window"]
    assert read(bare) is None
    assert read(None) is None
    assert registry.metric("decode_attn_ms").read(
        SimpleNamespace(kind="serve")) is None


def test_is_a_per_layer_metric_of_the_serving_cell():
    entry = {m["name"]: m for m in registry.benchmark()["per_layer"]}[
        "decode_attn_ms"]
    assert entry == {"name": "decode_attn_ms", "unit": "ms",
                     "better": "lower", "source": "device_trace",
                     "layer": "model step, decode", "moves": "itl_p95_ms",
                     "workloads": ["phi4-serve-longdoc"]}

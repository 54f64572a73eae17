"""The moonlight-serve-longgen cell on the CPU at the smoke config's sizes
(its own overrides: 4 lanes, prompts 16-128), its control, and the four
readers of latent attention's and the MoE block's spans on a synthetic
trace, each against a hand count.

The limits at these sizes are set as the cells' are, from readings at
the same overrides. The cell runs in float32 here, with its control in
bf16: at the smoke widths (d 64, 8 experts, top 3) a one-ulp bf16
difference flips a sigmoid route, and the bf16 program's widest gap over
seeds 1-12 (0.91) reaches the fp8 control's (0.90-1.32 over seeds 10-12).
In float32, on the first 32 requests of seeds 1-17 (128 served tokens),
the program's widest and median gaps are 0.0 on every seed; the bf16
control's widest 0.0077-2.60, its median 0.0 (at this size most
positions agree): the widest gap is compared here, limit 0.002, beside
the cell's own limits of the 90th-percentile gap and the largest request
median, which planted wrong tokens fail."""
import dataclasses
import itertools
import json
import time
from types import SimpleNamespace

import pytest

from perfbench import mla_flops, registry, run, traffic
from perfbench.trace import Trace
from repro_torch.serving import ServeRequest, ServingEngine

CELL = "moonlight-serve-longgen"
BENCH = registry.benchmark()
NEW = ("mla_decode_ms", "moe_decode_ms", "mla_prefill_ms_per_ktok",
       "k1_mla_roofline")


def overrides() -> dict:
    from repro_torch.configs.base import get_smoke_config

    return {"model": dict(dataclasses.asdict(
                get_smoke_config("moonlight_16b_a3b")), dtype="float32"),
            "mix": {"lanes": 4, "clients": 4, "max_len": 160,
                    "prompt_tokens": {"low": 16, "high": 128},
                    "output_tokens": {"low": 2, "high": 6}, "block": 8,
                    "warmup_steps": 6, "check": {"served_tokens": 120}},
            "limits": {"served_gap": {"limit": 0.002}}}


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_end_to_end_on_the_cpu(trace):
    result, notes = run.run_cell(CELL, 2 ** 31 + 13, 1.0, bool(trace),
                                 device="cpu", t_start=time.perf_counter(),
                                 overrides=overrides())
    line = json.loads(json.dumps(result))
    assert line["correct"] is True, (line["checks"], notes)
    assert set(line["checks"]) == {"served_gap", "served_gap_p90",
                                   "served_gap_request_median"}
    assert line["attempted"] > 0 and line["failed"] == 0
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in registry.metrics_of(CELL, BENCH, section)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == {"serve_tok_s", "ttft_p95_ms",
                                        "itl_p95_ms", "setup_s"}
    else:
        assert set(NEW) <= names
        # no device on the CPU: the readers of device time find nothing
        assert not set(NEW) & set(line["metrics"])
    # K1 and the decode kernel are not launched on CPU tensors
    assert not any(notes["counters"].values())


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_the_control_is_not_correct(seed):
    """The reference one precision below the configuration's, judged as
    the cell judges the program, fails the cell's limits; the program
    passes them. Served tokens of the first 32 requests of the seed's
    traffic, served by the engine whole (no window, so no timing)."""
    ctx, _, limits = run.make_context(CELL, seed, 1.0, False, "cpu",
                                      time.perf_counter(), overrides())
    control = ctx.ref.control_for(ctx.cfg)
    assert control == "bf16"
    eng = ServingEngine(ctx.model_cfg,
                        ctx.ref.make_params(ctx.cfg, seed, "cpu"), lanes=4,
                        max_len=ctx.mix["max_len"])
    reqs = [ServeRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
            for r in itertools.islice(traffic.requests(
                ctx.mix, seed, ctx.cfg["vocab_size"]), 32)]
    eng.run(reqs)
    gaps = registry.driver(ctx.mix["driver"]).served_gaps(
        ctx, [(r.prompt, r.output) for r in reqs], quant=control)
    assert gaps["gap"] <= limits["served_gap"]["limit"]
    for name, value in gaps["program"].items():
        assert value <= limits[name]["limit"]
    assert gaps["control_gap"] > limits["served_gap"]["limit"]


@pytest.mark.parametrize("seed", [10, 11])
def test_one_wrong_request_fails_the_cell(seed):
    """Served tokens planted wrong (each token + 1) in one of three
    checked requests, or past the middle of every request: the cell's
    own limits (set on the card) fail the first through a request's
    median gap and the second through the 90th percentile, while the
    sound requests pass every limit."""
    ctx, _, limits = run.make_context(CELL, seed, 1.0, False, "cpu",
                                      time.perf_counter(), overrides())
    eng = ServingEngine(ctx.model_cfg,
                        ctx.ref.make_params(ctx.cfg, seed, "cpu"), lanes=4,
                        max_len=ctx.mix["max_len"])
    reqs = [ServeRequest(prompt=r.prompt, max_new_tokens=8)
            for r in itertools.islice(traffic.requests(
                ctx.mix, seed, ctx.cfg["vocab_size"]), 3)]
    eng.run(reqs)
    V = ctx.cfg["vocab_size"]
    sound = [(r.prompt, r.output) for r in reqs]
    one = sound[:2] + [(sound[2][0], [(t + 1) % V for t in sound[2][1]])]
    late = [(p, o[:4] + [(t + 1) % V for t in o[4:]]) for p, o in sound]
    cell = registry.limits(CELL)
    check = registry.driver(ctx.mix["driver"]).served_gaps
    for name, value in check(ctx, sound)["program"].items():
        assert value <= cell[name]["limit"]
    got = check(ctx, one)["program"]
    assert got["served_gap_request_median"] > \
        cell["served_gap_request_median"]["limit"]
    got = check(ctx, late)["program"]
    assert got["served_gap_p90"] > cell["served_gap_p90"]["limit"]


CFG = {"n_layers": 2, "n_heads": 16,
       "mla": {"kv_lora_rank": 512, "qk_nope_head_dim": 128,
               "qk_rope_head_dim": 64, "v_head_dim": 128}}


def serve_run():
    """A window (us) of one prefill (two MLA layers, each launching K1,
    and an MoE block) and two decode steps (an MLA layer and an MoE block
    each), with an MLA span outside every engine span."""
    r = [("bench.window", 0.0, 10_000.0),
         ("engine.prefill", 100.0, 1100.0), ("model.mla", 200.0, 400.0),
         ("model.mla", 500.0, 700.0), ("model.moe", 800.0, 900.0),
         ("engine.decode", 2000.0, 3000.0), ("model.mla", 2100.0, 2300.0),
         ("model.moe", 2400.0, 2600.0),
         ("engine.decode", 4000.0, 5000.0), ("model.mla", 4100.0, 4300.0),
         ("model.moe", 4400.0, 4600.0),
         ("model.mla", 6000.0, 6100.0)]
    ops = [("flash_fwd_bf16", 250.0, 350.0, 210.0),   # prefill MLA: 100
           ("gemm", 300.0, 320.0, 220.0),             # prefill MLA: 20
           ("flash_fwd_bf16", 550.0, 700.0, 510.0),   # prefill MLA: 150
           ("gemm", 810.0, 850.0, 805.0),             # prefill MoE: 40
           ("bmm", 2150.0, 2250.0, 2110.0),           # decode 1 MLA: 100
           ("gemm", 2450.0, 2550.0, 2410.0),          # decode 1 MoE: 100
           ("bmm", 4150.0, 4200.0, 4110.0),           # decode 2 MLA: 50
           ("gemm", 4450.0, 4470.0, 4410.0),          # decode 2 MoE: 20
           ("gemm", 4700.0, 4800.0, 4700.0),          # decode 2, neither
           ("bmm", 6000.0, 6050.0, 6010.0),           # MLA outside engine
           ("memset", 0.0, 1.0, None)]                # placed nowhere
    return SimpleNamespace(
        kind="serve", cfg=CFG, trace=Trace((0.0, 10_000.0), ops, r, []),
        window=(10.0, 20.0),
        prefills=[(11.0, 11.5, 1500), (25.0, 25.5, 999)])   # 2nd: after


def metric(name):
    return registry.metric(name).read


def test_decode_readers_count_mla_and_moe_inside_decode_only():
    run_ = serve_run()
    assert metric("mla_decode_ms")(run_) == pytest.approx((100 + 50) / 1e3 / 2)
    assert metric("moe_decode_ms")(run_) == pytest.approx((100 + 20) / 1e3 / 2)


def test_mla_prefill_ms_per_ktok_over_the_windows_prompt_tokens():
    assert metric("mla_prefill_ms_per_ktok")(serve_run()) == pytest.approx(
        (100 + 20 + 150) / 1e3 / 1500 * 1e3)


def test_k1_mla_counts_by_hand():
    c = mla_flops.k1_mla_counts(1500, 16, 192, 128)
    assert c["flops"] == 2 * (1500 * 1501 // 2) * 16 * 320
    assert c["bytes"] == 2 * 1500 * 16 * (2 * 192 + 2 * 128)
    assert c["bound_s"] == max(c["flops"] / 989e12, c["bytes"] / 3.35e12)
    # at prefill lengths the operations bound it
    assert c["flops"] / 989e12 > c["bytes"] / 3.35e12


def test_k1_mla_roofline_over_k1s_device_time():
    bound = 2 * mla_flops.k1_mla_counts(1500, 16, 192, 128)["bound_s"]
    assert metric("k1_mla_roofline")(serve_run()) == pytest.approx(
        100.0 * bound / 250e-6)


def test_readers_find_nothing_without_their_spans_or_latent_attention():
    run_ = serve_run()
    bare = SimpleNamespace(kind="serve", cfg=CFG, window=run_.window,
                           prefills=run_.prefills,
                           trace=Trace((0.0, 10_000.0), run_.trace.ops,
                                       [("bench.window", 0.0, 10_000.0)], []))
    for name in NEW:
        assert metric(name)(bare) is None
        assert metric(name)(SimpleNamespace(
            kind="serve", cfg=CFG, trace=None, window=(0, 1),
            prefills=[])) is None
    dense = SimpleNamespace(**dict(vars(run_), cfg={"n_layers": 2,
                                                    "n_heads": 16}))
    assert metric("k1_mla_roofline")(dense) is None
    # K1 launches that are not one a layer a prefill are not read
    short = serve_run()
    short.trace.ops.pop(0)
    assert metric("k1_mla_roofline")(short) is None

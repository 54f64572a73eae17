"""The frozen operation and byte counts against hand counts at small
shapes, and the parameter count against the port's own layout."""
import dataclasses

import pytest
import torch

from perfbench import flops, peaks, registry
from perfbench.reference import transformer as ref

BENCH = registry.benchmark()


def small(moe: bool) -> dict:
    cfg = {"name": "t", "family": "moe" if moe else "dense", "n_layers": 2,
           "d_model": 8, "n_heads": 4, "n_kv_heads": 2, "head_dim": 2,
           "d_ff": 6, "vocab_size": 10, "act": "swiglu",
           "tie_embeddings": True, "dtype": "float32"}
    if moe:
        cfg["moe"] = {"n_experts": 4, "top_k": 2, "d_expert": 3, "every": 1}
    return cfg


def test_hand_counts_dense():
    cfg = small(False)
    # attention 8*2*(4+4) + 4*2*8 = 192; ffn 3*8*6 = 144; norms 16
    assert flops.attn_params(cfg) == 192
    assert flops.ffn_params(cfg, 0, active=True) == 144
    # embedding over 256 padded rows: 256*8; final norm 8
    assert flops.n_params(cfg) == 256 * 8 + 2 * (192 + 144 + 16) + 8
    # prefill of S=3: 2*3*(2*(192+144)) + 2 layers*4*4*2*6 pairs + 2*8*10
    assert flops.causal_pairs(3, 3) == 6
    assert flops.prefill_flops(cfg, 3) == 2 * 3 * 672 + 2 * 4 * 4 * 2 * 6 + 160


def test_hand_counts_moe():
    cfg = small(True)
    # experts 4*3*8*3 = 288 (active 2 of 4: 144), router 8*4 = 32
    assert flops.ffn_params(cfg, 0, active=False) == 288 + 32
    assert flops.ffn_params(cfg, 1, active=True) == 144 + 32
    n = flops.n_params(cfg)
    assert n == 256 * 8 + 2 * (192 + 320 + 16) + 8
    t = flops.train_flops(cfg, batch=2, seq=5)
    active = n - 2 * 3 * 8 * 3 * 2          # two idle experts a layer
    assert t["active_params"] == active
    assert t["weight_flops"] == 6 * active * 10
    assert t["attention_flops"] == 12 * 2 * 2 * 25 * 4 * 2
    assert t["flops"] == t["weight_flops"] + t["attention_flops"]


def test_k1_counts_by_hand():
    c = flops.k1_counts(S=4, T=4, Hq=2, Hkv=1, hd=8)
    assert c["flops"] == 4 * 2 * 8 * 10
    assert c["bytes"] == 2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8)
    assert c["bound_s"] == max(c["flops"] / peaks.BF16_FLOPS,
                               c["bytes"] / peaks.HBM_BYTES)
    # queries at the end of a longer key range
    assert flops.causal_pairs(2, 5) == 2 * 3 + 3
    # phi4's prefill at S=1000 is bound by operations (PR 15: 0.006219 ms)
    big = flops.k1_counts(1000, 1000, 24, 8, 128)
    assert big["flops"] / peaks.BF16_FLOPS > big["bytes"] / peaks.HBM_BYTES
    assert big["bound_s"] * 1e3 == pytest.approx(0.006219, rel=0.01)


@pytest.mark.parametrize("name", ["phi4_mini_3_8b", "granite_moe_1b_a400m"])
def test_parameter_count_matches_the_layouts(name):
    cfg = registry.config(name, BENCH)
    model = cfg["model"]
    n = flops.n_params(model)
    assert n == cfg["parameters"]
    specs = ref.param_specs(ref.sizes(model))
    assert sum(int(torch.Size(s).numel()) for s, _, _ in specs.values()) == n
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import build_model

    params = build_model(ModelConfig(**model)).init(0, device="meta")
    leaves = ref.flatten(params)
    assert set(leaves) == set(specs)
    for path, t in leaves.items():
        assert tuple(t.shape) == specs[path][0] and t.dtype == specs[path][1]


def test_published_sizes():
    phi = registry.config("phi4_mini_3_8b", BENCH)
    granite = registry.config("granite_moe_1b_a400m", BENCH)
    assert phi["parameters"] == 3_836_414_976
    assert granite["parameters"] == 1_334_887_424
    g = granite["model"]
    t = flops.train_flops(g, 8, 2048)
    assert t["tokens"] == 16384
    assert dataclasses.is_dataclass(ref.sizes(g))

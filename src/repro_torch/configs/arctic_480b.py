"""Snowflake Arctic 480B — 128-expert top-2 MoE with parallel dense residual.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2 + dense residual FFN.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    act="swiglu",
    moe=MoEConfig(
        n_experts=128,
        top_k=2,
        d_expert=4864,
        dense_residual=True,
        d_dense_residual=4864,
        every=1,
    ),
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="arctic-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=499,
    act="swiglu",
    moe=MoEConfig(
        n_experts=8, top_k=2, d_expert=96, dense_residual=True,
        d_dense_residual=96, every=1,
    ),
    max_seq_len=1024,
)

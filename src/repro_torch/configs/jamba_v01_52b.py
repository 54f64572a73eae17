"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Attention every 8th layer (1 attn : 7 mamba); MoE on every other layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    act="swiglu",
    attn_every=8,
    attn_offset=4,   # attention mid-block, as in the Jamba paper
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, every=2, offset=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    max_seq_len=524288,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=503,
    act="swiglu",
    attn_every=8,
    attn_offset=4,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128, every=2, offset=1),
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    max_seq_len=1024,
)

"""IBM Granite 3.0 1B-a400m — 32-expert top-8 MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 24L d_model=1024 16H (GQA kv=8)
d_ff=512 (per expert) vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    act="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512, every=1),
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=487,
    act="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=8, top_k=4, d_expert=64, every=1),
    max_seq_len=1024,
)

"""Gemma 2B — dense, GeGLU, MQA (kv=1), head_dim=256.

[arXiv:2403.08295; hf] 18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="geglu",
    tie_embeddings=True,
    max_seq_len=8192,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=541,
    act="geglu",
    tie_embeddings=True,
    max_seq_len=1024,
)

"""ChatGLM3 6B — dense, 2d (partial) RoPE, GQA kv=2.

[arXiv:2406.12793; hf] 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
ChatGLM applies rotary embedding to half the head dim (2d rope).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    act="swiglu",
    rope_fraction=0.5,
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="chatglm3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=547,
    act="swiglu",
    rope_fraction=0.5,
    max_seq_len=1024,
)

"""InternVL2 2B — InternLM2 backbone; InternViT frontend stubbed.

[arXiv:2404.16821; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The vision tower is a STUB per assignment: input_specs() provides precomputed
patch embeddings (frontend="vision"), prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    act="swiglu",
    frontend="vision",
    frontend_dim=1024,   # InternViT-300M patch embedding dim (pre-projector)
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=563,
    act="swiglu",
    frontend="vision",
    frontend_dim=32,
    max_seq_len=1024,
)

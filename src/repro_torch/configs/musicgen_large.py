"""MusicGen Large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] 48L d_model=2048 32H (kv=32, full MHA) d_ff=8192
vocab=2048. The EnCodec frontend is a STUB per assignment: input_specs()
provides precomputed frame embeddings (frontend="audio"). MusicGen uses a
plain (non-gated) GELU FFN.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    frontend="audio",
    frontend_dim=128,    # EnCodec latent frame dim
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    act="gelu",
    frontend="audio",
    frontend_dim=16,
    max_seq_len=1024,
)

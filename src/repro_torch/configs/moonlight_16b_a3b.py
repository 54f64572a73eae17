"""Moonlight-16B-A3B — DeepSeek-V3 blocks: latent attention, 64 experts.

[hf:moonshotai/Moonlight-16B-A3B config.json, model_type deepseek_v3] 27L
d_model=2048, 16 heads of MLA (kv_lora_rank 512, no q LoRA, qk_nope 128 +
qk_rope 64, v 128), rope_theta 50000, 8,192 positions; layer 0 a dense
SwiGLU of 11264, layers 1-26 MoE: 64 routed experts of 1408, top 6,
sigmoid scores with a selection bias (noaux_tc, one group), gates
renormalised and scaled by 2.446, 2 shared experts (one SwiGLU of 2816);
vocab 163840, untied; rms_norm_eps 1e-5. 15,960,110,208 parameters in the
port's layout. Not in ``ARCH_IDS``: the reference package has no MLA.
The port serves it (dropless routing), its decode steps replayed as CUDA
graphs; it does not train it.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,
    d_ff=11264,
    vocab_size=163840,
    act="swiglu",
    norm_eps=1e-5,
    rope_theta=50000.0,
    tie_embeddings=False,
    max_seq_len=8192,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, dense_residual=True,
                  d_dense_residual=2816, scoring="sigmoid",
                  selection_bias=True, routed_scale=2.446,
                  dropless=True, first_dense=1),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    scan_period=27,
)

SMOKE_CONFIG = ModelConfig(
    name="moonlight-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=24,
    d_ff=96,
    vocab_size=487,
    act="swiglu",
    norm_eps=1e-5,
    rope_theta=50000.0,
    tie_embeddings=False,
    max_seq_len=1024,
    moe=MoEConfig(n_experts=8, top_k=3, d_expert=32, dense_residual=True,
                  d_dense_residual=32, scoring="sigmoid",
                  selection_bias=True, routed_scale=2.446,
                  dropless=True, first_dense=1),
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16),
    scan_period=3,
)

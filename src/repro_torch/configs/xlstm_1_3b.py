"""xLSTM 1.3B — sLSTM + mLSTM block interleave (attention-free).

[arXiv:2405.04517; unverified] 48L d_model=2048 4H d_ff=0 vocab=50304.
Blocks alternate sLSTM (post-up-projection, factor 4/3) and mLSTM
(pre-up-projection, factor 2); no separate FFN (d_ff=0).

The name says 1.3B, but the repo's block shapes give CONFIG 2,926,053,568
parameters (6,861,103,872 bytes: the sLSTM gate weights and recurrent
weights are float32): 24 mLSTM blocks of 4096 inner width with three
4096x4096 q/k/v projections, 24 sLSTM blocks with four 2048x2048 input
weights, and an untied embedding and head over the vocabulary padded to
50432.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=2, slstm_offset=1),
    max_seq_len=524288,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    head_dim=32,
    d_ff=0,
    vocab_size=467,
    xlstm=XLSTMConfig(slstm_every=2, slstm_offset=1),
    max_seq_len=1024,
)

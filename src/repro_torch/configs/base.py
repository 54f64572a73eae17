"""Model and run configuration for the PyTorch port.

A copy of the reference package's ``ModelConfig`` (field for field, so a
reference config converts with ``ModelConfig(**dataclasses.asdict(cfg))``)
with its derived properties and analytic parameter count, and of its
run-time configs: ``ShapeConfig`` (one input-shape cell), the assigned
shapes and ``RunConfig`` (the trainer's batch, optimizer and schedule),
and the registry (``ARCH_IDS``, ``SHAPES_BY_NAME``) the mesh layer's dry
run sweeps (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    n_experts: int = 0
    top_k: int = 2
    d_expert: int = 0           # per-expert hidden dim (d_ff of one expert)
    dense_residual: bool = False  # arctic-style parallel dense FFN
    d_dense_residual: int = 0     # hidden dim of the dense residual branch
    every: int = 1               # MoE on layers where (layer % every == offset)
    offset: int = 0
    router_jitter: float = 0.0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # DeepSeek-V3 routing; the defaults are the softmax router above
    scoring: str = "softmax"     # softmax | sigmoid
    selection_bias: bool = False  # a float32 [E] bias on the scores that
    #                               changes which experts are chosen only
    routed_scale: float = 1.0    # the renormalised gates scaled by this
    dropless: bool = False       # every (token, choice) computed: no capacity
    first_dense: int = 0         # leading layers with a dense FFN (d_ff)

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective-scan block configuration."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block configuration (sLSTM + mLSTM interleave)."""

    slstm_every: int = 2      # sLSTM on layers where layer % every == offset
    slstm_offset: int = 0
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3) without a query LoRA:
    queries projected whole, keys and values through a normed latent of
    ``kv_lora_rank`` that the cache holds beside one shared RoPE key of
    ``qk_rope_head_dim``. 0 (the default): not used."""

    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


_SUB_CONFIGS = {"moe": MoEConfig, "ssm": SSMConfig, "xlstm": XLSTMConfig,
                "mla": MLAConfig}


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 1024           # dense FFN hidden (0 for pure-SSM archs)
    vocab_size: int = 1024
    act: str = "swiglu"        # swiglu | geglu | gelu
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # chatglm-style partial/2d rope: 0.5
    tie_embeddings: bool = False
    max_seq_len: int = 8192
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0     # 0 = full attention
    # hybrid (jamba): attention on layers where layer % attn_every == attn_offset
    attn_every: int = 1
    attn_offset: int = 0
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)
    # latent attention in place of GQA in every attention layer
    mla: MLAConfig = field(default_factory=MLAConfig)
    # modality frontend stub: precomputed embeddings of this dim replace the
    # first tokens
    frontend: str = "none"      # none | vision | audio
    frontend_dim: int = 0
    dtype: str = "bfloat16"
    # layers are grouped into n_layers // scan_period groups of `scan_period`
    # (possibly heterogeneous) layers. 0 -> auto from family.
    scan_period: int = 0
    remat: str = "block"        # training only; inference ignores it
    # serving only: each decode step on plain CUDA tensors with per-lane
    # positions replayed as CUDA graphs (models/decode_graph.py); False
    # runs it eagerly
    decode_graph: bool = True

    def __post_init__(self):
        # dataclasses.asdict() flattens the sub-configs to dicts; accept them
        for name, cls in _SUB_CONFIGS.items():
            value = getattr(self, name)
            if isinstance(value, dict):
                object.__setattr__(self, name, cls(**value))
        if self.moe.first_dense and \
                self.resolved_scan_period != self.n_layers:
            raise ValueError("leading dense layers (moe.first_dense) need "
                             "one group: scan_period = n_layers")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_scan_period(self) -> int:
        if self.scan_period:
            return self.scan_period
        period = 1
        if self.family == "hybrid":
            period = math.lcm(period, self.attn_every)
        if self.moe.enabled and self.moe.every > 1:
            period = math.lcm(period, self.moe.every)
        if self.family == "ssm":
            period = math.lcm(period, self.xlstm.slstm_every)
        return period

    @property
    def n_groups(self) -> int:
        p = self.resolved_scan_period
        if self.n_layers % p:
            raise ValueError(f"n_layers={self.n_layers} is not a multiple "
                             f"of the scan period {p}")
        return self.n_layers // p

    def layer_kind(self, layer_idx: int) -> str:
        """Kind of layer at absolute index: attn | mla | ssm | slstm |
        mlstm."""
        if self.family == "ssm":
            x = self.xlstm
            return "slstm" if layer_idx % x.slstm_every == x.slstm_offset else "mlstm"
        if self.family == "hybrid":
            if layer_idx % self.attn_every == self.attn_offset:
                return "mla" if self.mla.enabled else "attn"
            return "ssm"
        return "mla" if self.mla.enabled else "attn"

    def layer_is_moe(self, layer_idx: int) -> bool:
        m = self.moe
        return (m.enabled and layer_idx >= m.first_dense
                and layer_idx % m.every == m.offset)

    def param_count(self) -> Dict[str, float]:
        """Analytic parameter counts (total and active-per-token), the
        reference's formula (approximate for the xLSTM kinds)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = active = emb
        for li in range(self.n_layers):
            kind = self.layer_kind(li)
            if kind == "attn":
                blk = d * hd * (nq + 2 * nkv) + nq * hd * d  # qkv + out
            elif kind == "mla":
                a = self.mla
                r, rope = a.kv_lora_rank, a.qk_rope_head_dim
                blk = (d * nq * a.qk_head_dim + d * (r + rope)
                       + r * nq * (a.qk_nope_head_dim + a.v_head_dim)
                       + nq * a.v_head_dim * d)
            elif kind == "ssm":
                s = self.ssm
                d_in = s.expand * d
                dtr = s.dt_rank or -(-d // 16)
                blk = (d * 2 * d_in + d_in * s.d_conv
                       + d_in * (dtr + 2 * s.d_state) + dtr * d_in
                       + d_in * s.d_state + d_in + d_in * d)
            elif kind == "mlstm":
                d_in = int(self.xlstm.proj_factor_mlstm * d)
                blk = 2 * d * d_in + d_in * d  # up/gate + down
                blk += 4 * d_in * (d_in // max(self.n_heads, 1))  # qkv+i/f
            else:  # slstm
                d_in = int(self.xlstm.proj_factor_slstm * d)
                blk = 4 * d * d + 2 * d * d_in  # recurrent gates + ffn
            total += blk
            active += blk
            if kind in ("attn", "mla", "ssm") and self.d_ff:
                nmat = 3 if self.act in ("swiglu", "geglu") else 2
                if self.layer_is_moe(li):
                    m = self.moe
                    per = nmat * d * m.d_expert
                    total += m.n_experts * per
                    active += m.top_k * per
                    if m.dense_residual:
                        dd = nmat * d * (m.d_dense_residual or self.d_ff)
                        total += dd
                        active += dd
                else:
                    total += nmat * d * self.d_ff
                    active += nmat * d * self.d_ff
        return {"total": float(total), "active": float(active)}

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: a step kind at a sequence length and batch."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


# The four assigned LM shapes.
ASSIGNED_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in ASSIGNED_SHAPES}

# the reference registry's order
ARCH_IDS = (
    "jamba_v01_52b",
    "arctic_480b",
    "granite_moe_1b_a400m",
    "phi4_mini_3_8b",
    "codeqwen15_7b",
    "gemma_2b",
    "chatglm3_6b",
    "xlstm_1_3b",
    "internvl2_2b",
    "musicgen_large",
)


@dataclass(frozen=True)
class RunConfig:
    """What a training run does besides the model: batch, optimizer and
    schedule, with the reference's defaults. Only the fields the port's
    trainer reads: gradient accumulation, gradient compression and the
    kernels on the training path are not ported, and the checkpoint
    directory and period are the trainer's own arguments."""

    model: ModelConfig = field(default_factory=ModelConfig)
    seq_len: int = 512
    global_batch: int = 8
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k requires sub-quadratic attention (SSM/hybrid families)."""
    if shape.name == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


def _module(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    """The published (full-size) config of an architecture id."""
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """The reduced same-family smoke config of an architecture id."""
    return _module(arch).SMOKE_CONFIG

from repro_torch.configs.base import (
    ASSIGNED_SHAPES,
    ModelConfig,
    MoEConfig,
    RunConfig,
    ShapeConfig,
    SSMConfig,
    XLSTMConfig,
    get_config,
    get_smoke_config,
    supports_shape,
)

__all__ = [
    "ASSIGNED_SHAPES",
    "ModelConfig",
    "MoEConfig",
    "RunConfig",
    "SSMConfig",
    "ShapeConfig",
    "XLSTMConfig",
    "get_config",
    "get_smoke_config",
    "supports_shape",
]

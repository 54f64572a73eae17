from repro_torch.configs.base import (
    ARCH_IDS,
    ASSIGNED_SHAPES,
    SHAPES_BY_NAME,
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
    "ARCH_IDS",
    "ASSIGNED_SHAPES",
    "SHAPES_BY_NAME",
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

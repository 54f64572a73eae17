from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    XLSTMConfig,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "XLSTMConfig",
    "get_config",
    "get_smoke_config",
]

from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ArchConfig,
    ShapeConfig,
    all_configs,
    get_config,
    register,
)

__all__ = [
    "ARCH_IDS", "SHAPES", "ArchConfig", "ShapeConfig", "all_configs", "get_config",
    "register",
]

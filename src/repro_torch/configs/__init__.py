from .base import (
    ARCH_IDS,
    ArchConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    get_config,
    get_smoke_config,
    shape_applicable,
)

__all__ = [
    "ARCH_IDS", "ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "get_config", "get_smoke_config", "shape_applicable",
]

from repro_torch.config.base import (
    ArchConfig,
    DiTConfig,
    RippleConfig,
    ShapeSpec,
    VDiTConfig,
    apply_overrides,
)

__all__ = ["ArchConfig", "DiTConfig", "RippleConfig", "ShapeSpec",
           "VDiTConfig", "apply_overrides"]

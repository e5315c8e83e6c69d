from repro_torch.config.base import (
    ArchConfig,
    RippleConfig,
    ShapeSpec,
    VDiTConfig,
    apply_overrides,
)

__all__ = ["ArchConfig", "RippleConfig", "ShapeSpec", "VDiTConfig",
           "apply_overrides"]

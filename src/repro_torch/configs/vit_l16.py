"""vit-l16 [vision] — img_res=224 patch=16 n_layers=24 d_model=1024
n_heads=16 d_ff=4096.  Same values as the JAX package's
``repro.configs.vit_l16`` [arXiv:2010.11929; paper].

TimeRipple: available as a 2-D extension (x/y axes, a fixed threshold
over a single forward); off by default."""

from repro_torch.config.base import ArchConfig, RippleConfig, ViTConfig
from repro_torch.configs.lm_shapes import VISION_SHAPES


def make_config() -> ArchConfig:
    model = ViTConfig(img_res=224, patch=16, num_layers=24, d_model=1024,
                      num_heads=16, d_ff=4096)
    return ArchConfig(name="vit-l16", family="vit", model=model,
                      shapes=VISION_SHAPES,
                      ripple=RippleConfig(enabled=False, axes=("x", "y")),
                      source="arXiv:2010.11929; paper")


def make_smoke_config() -> ArchConfig:
    model = ViTConfig(img_res=32, patch=8, num_layers=2, d_model=64,
                      num_heads=4, d_ff=128, num_classes=10)
    cfg = make_config()
    return ArchConfig(name="vit-l16-smoke", family="vit", model=model,
                      shapes=cfg.shapes, ripple=cfg.ripple)

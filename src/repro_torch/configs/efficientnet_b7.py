"""efficientnet-b7 [vision] — img_res=600 width_mult=2.0 depth_mult=3.1.
Same values as the JAX package's ``repro.configs.efficientnet_b7``
[arXiv:1905.11946; paper].

TimeRipple: inapplicable (an attention-free convolutional network)."""

from repro_torch.config.base import ArchConfig, EffNetConfig, RippleConfig
from repro_torch.configs.lm_shapes import VISION_SHAPES


def make_config() -> ArchConfig:
    model = EffNetConfig(img_res=600, width_mult=2.0, depth_mult=3.1)
    return ArchConfig(name="efficientnet-b7", family="effnet", model=model,
                      shapes=VISION_SHAPES, ripple=RippleConfig(enabled=False),
                      source="arXiv:1905.11946; paper")


def make_smoke_config() -> ArchConfig:
    model = EffNetConfig(img_res=64, width_mult=0.35, depth_mult=0.35,
                         num_classes=10)
    cfg = make_config()
    return ArchConfig(name="efficientnet-b7-smoke", family="effnet",
                      model=model, shapes=cfg.shapes, ripple=cfg.ripple)

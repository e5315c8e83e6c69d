"""dit-b2 [diffusion] — img_res=256 patch=2 n_layers=12 d_model=768
n_heads=12.  Same values as the JAX package's ``repro.configs.dit_b2``
[arXiv:2212.09748; paper].

TimeRipple: 2-D mode (x/y axes)."""

from repro_torch.config.base import (ArchConfig, DiTConfig, RippleConfig,
                                     TrainConfig)
from repro_torch.configs.dit_xl2 import DIFFUSION_SHAPES


def make_config() -> ArchConfig:
    model = DiTConfig(img_res=256, patch=2, num_layers=12, d_model=768,
                      num_heads=12)
    ripple = RippleConfig(enabled=True, axes=("x", "y"),
                          theta_min=0.2, theta_max=0.5, i_min=10, i_max=20)
    return ArchConfig(name="dit-b2", family="dit", model=model,
                      shapes=DIFFUSION_SHAPES, ripple=ripple,
                      train=TrainConfig(grad_accum=8),
                      source="arXiv:2212.09748; paper")


def make_smoke_config() -> ArchConfig:
    model = DiTConfig(img_res=32, patch=2, num_layers=2, d_model=48,
                      num_heads=4)
    cfg = make_config()
    return ArchConfig(name="dit-b2-smoke", family="dit", model=model,
                      shapes=cfg.shapes, ripple=cfg.ripple)

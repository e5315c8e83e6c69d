"""dit-xl2 [diffusion] — img_res=256 patch=2 n_layers=28 d_model=1152
n_heads=16 (head dim 72).  Same values as the JAX package's
``repro.configs.dit_xl2`` [arXiv:2212.09748; paper].

TimeRipple: 2-D mode (x/y axes; an image DiT has no temporal axis)."""

from repro_torch.config.base import (ArchConfig, DiTConfig, RippleConfig,
                                     ShapeSpec)

# The JAX package's ``configs.lm_shapes.DIFFUSION_SHAPES``.
DIFFUSION_SHAPES = (
    ShapeSpec(name="train_256", kind="train", img_res=256, batch=256,
              steps=1000),
    ShapeSpec(name="gen_1024", kind="generate", img_res=1024, batch=4,
              steps=50),
    ShapeSpec(name="gen_fast", kind="generate", img_res=512, batch=16,
              steps=4),
    ShapeSpec(name="train_1024", kind="train", img_res=1024, batch=32,
              steps=1000),
)


def make_config() -> ArchConfig:
    model = DiTConfig(img_res=256, patch=2, num_layers=28, d_model=1152,
                      num_heads=16)
    ripple = RippleConfig(enabled=True, axes=("x", "y"),
                          theta_min=0.2, theta_max=0.5, i_min=10, i_max=20)
    return ArchConfig(name="dit-xl2", family="dit", model=model,
                      shapes=DIFFUSION_SHAPES, ripple=ripple,
                      source="arXiv:2212.09748; paper")


def make_smoke_config() -> ArchConfig:
    model = DiTConfig(img_res=32, patch=2, num_layers=2, d_model=64,
                      num_heads=4)
    cfg = make_config()
    return ArchConfig(name="dit-xl2-smoke", family="dit", model=model,
                      shapes=cfg.shapes, ripple=cfg.ripple)

"""flux-dev [diffusion] — img_res=1024 latent_res=128 n_double_blocks=19
n_single_blocks=38 d_model=3072 n_heads=24 (head dim 128), 12B params,
MMDiT rectified-flow.  Same values as the JAX package's
``repro.configs.flux_dev`` [BFL tech report; unverified].

TimeRipple: 2-D mode on the image-token stream of the joint attention
(text tokens never snapped)."""

from repro_torch.config.base import (ArchConfig, MMDiTConfig, RippleConfig,
                                     TrainConfig)
from repro_torch.configs.dit_xl2 import DIFFUSION_SHAPES


def make_config() -> ArchConfig:
    model = MMDiTConfig(img_res=1024, latent_res=128, n_double_blocks=19,
                        n_single_blocks=38, d_model=3072, num_heads=24,
                        in_channels=16, patch=2, txt_tokens=512,
                        txt_dim=4096, axes_dim=(16, 56, 56))
    ripple = RippleConfig(enabled=True, axes=("x", "y"),
                          theta_min=0.2, theta_max=0.5, i_min=10, i_max=20)
    return ArchConfig(name="flux-dev", family="mmdit", model=model,
                      shapes=DIFFUSION_SHAPES, ripple=ripple,
                      train=TrainConfig(grad_accum=16),
                      source="BFL tech report; unverified")


def make_smoke_config() -> ArchConfig:
    model = MMDiTConfig(img_res=64, latent_res=8, n_double_blocks=2,
                        n_single_blocks=2, d_model=64, num_heads=4,
                        in_channels=4, patch=2, txt_tokens=8, txt_dim=64,
                        axes_dim=(4, 6, 6))
    cfg = make_config()
    return ArchConfig(name="flux-dev-smoke", family="mmdit", model=model,
                      shapes=cfg.shapes, ripple=cfg.ripple)

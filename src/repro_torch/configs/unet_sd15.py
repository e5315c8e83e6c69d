"""unet-sd15 [diffusion] — img_res=512 latent_res=64 ch=320
ch_mult=1-2-4-4 n_res_blocks=2 attn_res=4-2-1 ctx_dim=768, 8 heads (head
dims 40, 80 and 160 at the three attention levels).  Same values as the
JAX package's ``repro.configs.unet_sd15`` [arXiv:2112.10752; paper].

TimeRipple: 2-D mode in the self-attention of the transformer blocks at
each attention resolution; cross-attention untouched."""

from repro_torch.config.base import (ArchConfig, RippleConfig, TrainConfig,
                                     UNetConfig)
from repro_torch.configs.dit_xl2 import DIFFUSION_SHAPES


def make_config() -> ArchConfig:
    model = UNetConfig(img_res=512, latent_res=64, ch=320,
                       ch_mult=(1, 2, 4, 4), n_res_blocks=2,
                       attn_res=(4, 2, 1), ctx_dim=768, num_heads=8,
                       ctx_tokens=77)
    ripple = RippleConfig(enabled=True, axes=("x", "y"),
                          theta_min=0.2, theta_max=0.5, i_min=10, i_max=20)
    return ArchConfig(name="unet-sd15", family="unet", model=model,
                      shapes=DIFFUSION_SHAPES, ripple=ripple,
                      train=TrainConfig(grad_accum=8),
                      source="arXiv:2112.10752; paper")


def make_smoke_config() -> ArchConfig:
    model = UNetConfig(img_res=64, latent_res=8, ch=32, ch_mult=(1, 2),
                       n_res_blocks=1, attn_res=(1, 2), ctx_dim=32,
                       num_heads=4, ctx_tokens=5)
    cfg = make_config()
    return ArchConfig(name="unet-sd15-smoke", family="unet", model=model,
                      shapes=cfg.shapes, ripple=cfg.ripple)

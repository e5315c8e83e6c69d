"""vdit-paper — the paper's native architecture: a HunyuanVideo-class 3-D
video DiT with factorized (t, x, y) RoPE (head split 16/56/56, paper
§3.2) and joint text tokens.  Same values as the JAX package's
``repro.configs.vdit_paper``; the Eq. 4 schedule comes from paper Tbl. 1
(HunyuanVideo row, column headers fixed — DESIGN.md §5)."""

from repro_torch.config.base import (ArchConfig, RippleConfig, ShapeSpec,
                                     VDiTConfig)

VDIT_SHAPES = (
    ShapeSpec(name="train_256", kind="train", img_res=256, batch=64,
              steps=1000),
    ShapeSpec(name="gen_512", kind="generate", img_res=512, batch=1,
              steps=50),
)


def make_config() -> ArchConfig:
    model = VDiTConfig(
        frames=128, img_res=512, patch=2, t_patch=1, num_layers=40,
        d_model=3072, num_heads=24, in_channels=16, vae_factor=8,
        t_vae_factor=4, txt_tokens=256, txt_dim=4096,
        axes_dim=(16, 56, 56),
    )
    ripple = RippleConfig(enabled=True, axes=("t", "x", "y"),
                          theta_min=0.2, theta_max=0.5, i_min=10, i_max=20,
                          channel_groups=(16 / 128, 56 / 128, 56 / 128))
    return ArchConfig(name="vdit-paper", family="vdit", model=model,
                      shapes=VDIT_SHAPES, ripple=ripple,
                      source="paper (HunyuanVideo-class)")


def make_smoke_config() -> ArchConfig:
    model = VDiTConfig(
        frames=16, img_res=64, patch=2, t_patch=1, num_layers=2,
        d_model=128, num_heads=2, in_channels=4, vae_factor=8,
        t_vae_factor=4, txt_tokens=8, txt_dim=64, axes_dim=(16, 24, 24),
    )
    cfg = make_config()
    return ArchConfig(name="vdit-paper-smoke", family="vdit", model=model,
                      shapes=cfg.shapes, ripple=cfg.ripple)

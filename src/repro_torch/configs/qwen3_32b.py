"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) head_dim=128
d_ff=25600 vocab=151936, qk-norm.  Same values as the JAX package's
``repro.configs.qwen3_32b`` [hf:Qwen/Qwen3-8B; hf].

TimeRipple: inapplicable (1-D text tokens)."""

from repro_torch.config.base import (ArchConfig, LMConfig, RippleConfig,
                                     TrainConfig)
from repro_torch.configs.lm_shapes import LM_SHAPES


def make_config() -> ArchConfig:
    model = LMConfig(
        num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
        d_ff=25600, vocab_size=151936, head_dim=128, qk_norm=True,
        rope_theta=1_000_000.0,
    )
    return ArchConfig(name="qwen3-32b", family="lm", model=model,
                      shapes=LM_SHAPES, ripple=RippleConfig(enabled=False),
                      train=TrainConfig(grad_accum=16),
                      source="hf:Qwen/Qwen3-8B; hf")


def make_smoke_config() -> ArchConfig:
    model = LMConfig(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=8, qk_norm=True,
    )
    cfg = make_config()
    return ArchConfig(name="qwen3-32b-smoke", family="lm", model=model,
                      shapes=cfg.shapes, ripple=cfg.ripple)

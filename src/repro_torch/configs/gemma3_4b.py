"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) head_dim=256
d_ff=10240 vocab=262144, qk-norm, 5:1 local:global sliding window of
1024.  Same values as the JAX package's ``repro.configs.gemma3_4b``
[hf:google/gemma-3-1b-pt; unverified].

TimeRipple: inapplicable (1-D text tokens)."""

from repro_torch.config.base import (ArchConfig, LMConfig, RippleConfig,
                                     TrainConfig)
from repro_torch.configs.lm_shapes import LM_SHAPES


def make_config() -> ArchConfig:
    model = LMConfig(
        num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
        d_ff=10240, vocab_size=262144, head_dim=256, qk_norm=True,
        sliding_window=1024, local_global_pattern=5,
        rope_theta=1_000_000.0,
    )
    return ArchConfig(name="gemma3-4b", family="lm", model=model,
                      shapes=LM_SHAPES, ripple=RippleConfig(enabled=False),
                      train=TrainConfig(grad_accum=8),
                      source="hf:google/gemma-3-1b-pt; unverified")


def make_smoke_config() -> ArchConfig:
    model = LMConfig(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, qk_norm=True,
        sliding_window=8, local_global_pattern=2,
    )
    cfg = make_config()
    return ArchConfig(name="gemma3-4b-smoke", family="lm", model=model,
                      shapes=cfg.shapes, ripple=cfg.ripple)

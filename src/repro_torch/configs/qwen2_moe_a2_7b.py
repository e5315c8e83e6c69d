"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) head_dim=128
vocab=151936, MoE: 60 routed experts padded to 64, top-4, of width 1408,
plus 4 shared experts.  Same values as the JAX package's
``repro.configs.qwen2_moe_a2_7b`` [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

TimeRipple: inapplicable (1-D text tokens)."""

from repro_torch.config.base import (ArchConfig, LMConfig, MoEConfig,
                                     RippleConfig, TrainConfig)
from repro_torch.configs.lm_shapes import LM_SHAPES


def make_config() -> ArchConfig:
    model = LMConfig(
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=151936, head_dim=128,
        moe=MoEConfig(num_experts=64, num_shared_experts=4, top_k=4,
                      expert_ffw_dim=1408, capacity_factor=1.25),
    )
    return ArchConfig(name="qwen2-moe-a2.7b", family="lm", model=model,
                      shapes=LM_SHAPES, ripple=RippleConfig(enabled=False),
                      train=TrainConfig(grad_accum=8),
                      source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf")


def make_smoke_config() -> ArchConfig:
    model = LMConfig(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=64,
        vocab_size=256, head_dim=16,
        moe=MoEConfig(num_experts=8, num_shared_experts=2, top_k=4,
                      expert_ffw_dim=64, capacity_factor=2.0),
    )
    cfg = make_config()
    return ArchConfig(name="qwen2-moe-smoke", family="lm", model=model,
                      shapes=cfg.shapes, ripple=cfg.ripple)

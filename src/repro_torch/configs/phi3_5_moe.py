"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8)
head_dim=128 vocab=32064, MoE: 16 experts of width 6400, top-2.  Same
values as the JAX package's ``repro.configs.phi3_5_moe``
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

TimeRipple: inapplicable (1-D text tokens)."""

from repro_torch.config.base import (ArchConfig, LMConfig, MoEConfig,
                                     RippleConfig, TrainConfig)
from repro_torch.configs.lm_shapes import LM_SHAPES


def make_config() -> ArchConfig:
    model = LMConfig(
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=6400, vocab_size=32064, head_dim=128,
        moe=MoEConfig(num_experts=16, num_shared_experts=0, top_k=2,
                      expert_ffw_dim=6400, capacity_factor=1.25),
    )
    return ArchConfig(name="phi3.5-moe-42b-a6.6b", family="lm", model=model,
                      shapes=LM_SHAPES, ripple=RippleConfig(enabled=False),
                      train=TrainConfig(grad_accum=16),
                      source="hf:microsoft/Phi-3.5-MoE-instruct; hf")


def make_smoke_config() -> ArchConfig:
    model = LMConfig(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, d_ff=96,
        vocab_size=256, head_dim=8,
        moe=MoEConfig(num_experts=4, num_shared_experts=0, top_k=2,
                      expert_ffw_dim=96, capacity_factor=2.0),
    )
    cfg = make_config()
    return ArchConfig(name="phi3.5-moe-smoke", family="lm", model=model,
                      shapes=cfg.shapes, ripple=cfg.ripple)

"""Workload shapes shared across archs, as in the JAX package's
``configs.lm_shapes``: the vision family's so far (``DIFFUSION_SHAPES``
live in ``configs.dit_xl2``; the LM shapes come with the LM family)."""

from repro_torch.config.base import ShapeSpec

VISION_SHAPES = (
    ShapeSpec(name="cls_224", kind="train", img_res=224, batch=256),
    ShapeSpec(name="cls_384", kind="train", img_res=384, batch=64),
    ShapeSpec(name="serve_b1", kind="classify", img_res=224, batch=1),
    ShapeSpec(name="serve_b128", kind="classify", img_res=224, batch=128),
)

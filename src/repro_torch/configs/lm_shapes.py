"""Workload shapes shared across archs, as in the JAX package's
``configs.lm_shapes``: the LM family's four and the vision family's
(``DIFFUSION_SHAPES`` live in ``configs.dit_xl2``)."""

from repro_torch.config.base import ShapeSpec

LM_SHAPES = (
    ShapeSpec(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeSpec(name="prefill_32k", kind="prefill", seq_len=32768,
              global_batch=32),
    ShapeSpec(name="decode_32k", kind="decode", seq_len=32768,
              global_batch=128),
    ShapeSpec(name="long_500k", kind="decode", seq_len=524288,
              global_batch=1),
)

VISION_SHAPES = (
    ShapeSpec(name="cls_224", kind="train", img_res=224, batch=256),
    ShapeSpec(name="cls_384", kind="train", img_res=384, batch=64),
    ShapeSpec(name="serve_b1", kind="classify", img_res=224, batch=1),
    ShapeSpec(name="serve_b128", kind="classify", img_res=224, batch=128),
)

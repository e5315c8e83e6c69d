"""Serving helpers of the port: per-request latent shapes, attention
token counts, a deterministic request stream, per-request class labels,
and one denoiser forward (vdit and dit families)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import ArchConfig, ShapeSpec


def latent_shape_for(arch: ArchConfig, shape: ShapeSpec) -> Tuple[int, ...]:
    """Per-request latent shape (no batch dim) for one generate cell — the
    serving engine's bucket identity."""
    m = arch.model
    if arch.family == "dit":
        lr = m.latent_res(shape.img_res)
        return (lr, lr, m.in_channels)
    if arch.family == "vdit":
        g = m.grid(img_res=shape.img_res)
        return (g[0] * m.t_patch, g[1] * m.patch, g[2] * m.patch,
                m.in_channels)
    raise ValueError(f"no latent shape for family {arch.family!r} in the "
                     f"port yet")


def attention_tokens(arch: ArchConfig, shape: ShapeSpec) -> int:
    """Tokens of the cell's joint self-attention (text + grid for the
    vdit, the patch grid for the dit)."""
    m = arch.model
    if arch.family == "dit":
        return m.num_tokens(shape.img_res)
    if arch.family == "vdit":
        g = m.grid(img_res=shape.img_res)
        return g[0] * g[1] * g[2] + m.txt_tokens
    raise ValueError(f"family {arch.family!r} is not ported yet")


def request_label(seed: int, num_classes: int) -> int:
    """A DiT request's class label, drawn from a CPU ``torch.Generator``
    seeded with the request's seed: the same on every device and
    whatever requests share its batch."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return int(torch.randint(0, num_classes, (), generator=gen))


def mixed_request_stream(arch: ArchConfig, shapes, num_requests: int,
                         seed: int = 0):
    """Round-robin (ShapeSpec, GenRequest) traffic over ``shapes`` with
    deterministic per-request text embeddings (numpy, seeded per
    request; a family without text gets the JAX package's (8, 64)
    stand-in, which its sampler ignores) and seeds."""
    from repro_torch.serving.engine import GenRequest

    m = arch.model
    txt_tokens = getattr(m, "txt_tokens", 8)
    txt_dim = getattr(m, "txt_dim", 64)
    out = []
    for i in range(num_requests):
        sp = shapes[i % len(shapes)]
        txt = 0.05 * np.random.default_rng(seed + i).standard_normal(
            (txt_tokens, txt_dim)).astype(np.float32)
        out.append((sp, GenRequest(
            request_id=i, txt=txt, steps=sp.steps, seed=seed + i,
            latent_shape=latent_shape_for(arch, sp))))
    return out


def _denoise_call(arch: ArchConfig, model, x: torch.Tensor, t: torch.Tensor,
                  cond: dict, step: Optional[int], total: Optional[int],
                  use_ripple: bool = True,
                  compute_dtype: torch.dtype = torch.bfloat16):
    """One denoiser forward: ``cond`` holds ``txt`` for the vdit and
    ``labels`` for the dit, whose sigma channels are dropped (the DDIM
    path uses the noise prediction only)."""
    rip = arch.ripple if use_ripple else dataclasses.replace(
        arch.ripple, enabled=False)
    kw = dict(ripple=rip, step=step, total_steps=total,
              compute_dtype=compute_dtype)
    if arch.family == "dit":
        out = model(x, t, cond["labels"], **kw)
        return out[..., :arch.model.in_channels]
    if arch.family == "vdit":
        return model(x, t, cond["txt"], **kw)
    raise ValueError(f"family {arch.family!r} is not ported yet")

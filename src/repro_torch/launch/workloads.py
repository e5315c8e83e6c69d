"""Serving helpers of the port: per-request latent shapes, a deterministic
request stream, and one denoiser forward (vdit family)."""

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
    if arch.family != "vdit":
        raise ValueError(f"no latent shape for family {arch.family!r} in "
                         f"the port yet")
    g = m.grid(img_res=shape.img_res)
    return (g[0] * m.t_patch, g[1] * m.patch, g[2] * m.patch, m.in_channels)


def mixed_request_stream(arch: ArchConfig, shapes, num_requests: int,
                         seed: int = 0):
    """Round-robin (ShapeSpec, GenRequest) traffic over ``shapes`` with
    deterministic per-request text embeddings (numpy, seeded per
    request) and seeds."""
    from repro_torch.serving.engine import GenRequest

    m = arch.model
    out = []
    for i in range(num_requests):
        sp = shapes[i % len(shapes)]
        txt = 0.05 * np.random.default_rng(seed + i).standard_normal(
            (m.txt_tokens, m.txt_dim)).astype(np.float32)
        out.append((sp, GenRequest(
            request_id=i, txt=txt, steps=sp.steps, seed=seed + i,
            latent_shape=latent_shape_for(arch, sp))))
    return out


def _denoise_call(arch: ArchConfig, model, x: torch.Tensor, t: torch.Tensor,
                  cond: dict, step: Optional[int], total: Optional[int],
                  use_ripple: bool = True,
                  compute_dtype: torch.dtype = torch.bfloat16):
    """One denoiser forward (vdit family)."""
    if arch.family != "vdit":
        raise ValueError(f"family {arch.family!r} is not ported yet")
    rip = arch.ripple if use_ripple else dataclasses.replace(
        arch.ripple, enabled=False)
    return model(x, t, cond["txt"], ripple=rip, step=step, total_steps=total,
                 compute_dtype=compute_dtype)

"""Seeded synthetic data of the port.

No datasets ship with the repository, so benchmarks draw latent videos
from a Gauss-Markov model whose knobs set how much spatio-temporal
redundancy TimeRipple can reuse.  Randomness comes from a caller's
``torch.Generator`` (whose device the data lands on); the deterministic
part is :func:`smooth_ar_latents`, a function of the base noise alone,
so the same noise gives the JAX package's latents.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def smooth_ar_latents(base: torch.Tensor, *, temporal_rho: float = 0.9,
                      spatial_smooth: int = 2) -> torch.Tensor:
    """(B, T, H, W, C) base noise -> latents: box-smoothed
    ``spatial_smooth`` times over (H, W) with wrap-around, then AR(1)
    across frames with coefficient ``temporal_rho`` (the first frame's
    state is its own smoothed noise, as the reference's scan carries it),
    then normalised by the population std of the whole tensor."""
    x = base
    for _ in range(spatial_smooth):
        x = (x + torch.roll(x, 1, 2) + torch.roll(x, -1, 2)
             + torch.roll(x, 1, 3) + torch.roll(x, -1, 3)) / 5.0
    c = math.sqrt(1 - temporal_rho ** 2)
    carry = x[:, 0]
    frames = []
    for t in range(x.shape[1]):
        carry = temporal_rho * carry + c * x[:, t]
        frames.append(carry)
    out = torch.stack(frames, dim=1)
    return out / (out.std(correction=0) + 1e-6)


def correlated_video_latents(generator: torch.Generator, batch: int,
                             grid: Tuple[int, int, int], channels: int, *,
                             temporal_rho: float = 0.9,
                             spatial_smooth: int = 2) -> torch.Tensor:
    """(B, T, H, W, C) float32 Gauss-Markov latents on the generator's
    device.  High rho / smooth => high spatio-temporal redundancy."""
    T, H, W = grid
    base = torch.randn((batch, T, H, W, channels), generator=generator,
                       device=generator.device)
    return smooth_ar_latents(base, temporal_rho=temporal_rho,
                             spatial_smooth=spatial_smooth)

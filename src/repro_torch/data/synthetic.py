"""Seeded synthetic data of the port.

No datasets ship with the repository, so benchmarks and the trainer draw
latent videos from a Gauss-Markov model whose knobs set how much
spatio-temporal redundancy TimeRipple can reuse, the vision family
class-conditional textures and the LM family Zipf token streams.
Randomness comes from a caller's ``torch.Generator`` (whose device the
data lands on); the deterministic
part is :func:`smooth_ar_latents`, a function of the base noise alone,
so the same noise gives the JAX package's latents.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Tuple

import numpy as np
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


# --- training batches ---------------------------------------------------------
#
# The JAX package's ``data/synthetic.py`` pipelines, drawn from a CPU
# generator seeded by (seed + the reference's per-pipeline offset, index,
# shard): a batch depends on its index only, on every device, so an
# iterator resumed at ``start_index`` replays the same batches (the
# values differ from the JAX draws, as ``torch`` and ``jax.random`` do).


@dataclasses.dataclass(frozen=True)
class DataSpec:
    seed: int = 0
    shard: int = 0
    num_shards: int = 1


def batch_generator(seed: int, index: int, shard: int = 0) -> torch.Generator:
    """The CPU generator of one batch: a function of (seed, index, shard).
    The train step draws a micro-batch's noise from (seed, step, micro)."""
    state = np.random.SeedSequence([seed, index, shard]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator()
    gen.manual_seed(int(state))
    return gen


def token_batch(spec: DataSpec, index: int, batch: int, seq_len: int,
                vocab: int, device=None) -> dict:
    """Zipf tokens with 8-token motif repetition (next-token learnable):
    ids ``vocab ** u - 1`` for u uniform in [1e-6, 1), truncated and
    clipped to [0, vocab); every odd 8-token window repeats the window
    before it.  ``tokens`` are the ids without the last and ``targets``
    without the first, each padded with one 0 column: (B, S) int64 on
    ``device``."""
    gen = batch_generator(spec.seed, index, spec.shard)
    u = 1e-6 + (1.0 - 1e-6) * torch.rand((batch, seq_len), generator=gen)
    ids = torch.clip(torch.pow(float(vocab), u) - 1, 0, vocab - 1).long()
    gate = (torch.arange(seq_len) // 8) % 2 == 1
    ids = torch.where(gate[None, :], torch.roll(ids, 8, dims=1), ids)
    pad = torch.zeros((batch, 1), dtype=torch.long)
    return {"tokens": torch.cat([ids[:, :-1], pad], 1).to(device),
            "targets": torch.cat([ids[:, 1:], pad], 1).to(device)}


def latent_video_batch(spec: DataSpec, index: int, batch: int,
                       grid: Tuple[int, int, int], channels: int,
                       txt_tokens: int = 0, txt_dim: int = 0,
                       device=None) -> dict:
    """``latents`` (B, T, H, W, C) Gauss-Markov latents and, with
    ``txt_tokens``, ``txt`` (B, L, txt_dim) text embeddings of std 0.05,
    float32 on ``device`` (default the CPU)."""
    gen = batch_generator(spec.seed + 7, index, spec.shard)
    out = {"latents": correlated_video_latents(gen, batch, grid, channels)}
    if txt_tokens:
        out["txt"] = 0.05 * torch.randn((batch, txt_tokens, txt_dim),
                                        generator=gen)
    return {k: v.to(device) for k, v in out.items()}


def image_batch(spec: DataSpec, index: int, batch: int, res: int,
                channels: int = 3, num_classes: int = 1000,
                device=None) -> dict:
    """Class-conditional band-limited textures (classifiable): ``images``
    (B, res, res, C) float32 and ``labels`` (B,) int64 on ``device``."""
    gen = batch_generator(spec.seed + 13, index, spec.shard)
    labels = torch.randint(0, num_classes, (batch,), generator=gen)
    freq = 1.0 + (labels % 8).float()
    xx = torch.linspace(0, 2 * math.pi, res)
    pattern = torch.sin(freq[:, None, None] * xx[None, :, None]
                        + freq[:, None, None] * 0.5 * xx[None, None, :])
    noise = 0.3 * torch.randn((batch, res, res, channels), generator=gen)
    images = pattern[..., None] + noise
    return {"images": images.to(device), "labels": labels.to(device)}


def batch_iterator(make_batch, spec: DataSpec,
                   start_index: int = 0) -> Iterator:
    """Infinite deterministic iterator with a resumable cursor."""
    i = start_index
    while True:
        yield make_batch(spec, i)
        i += 1

"""Diffusion noise schedules: DDPM (linear/cosine betas) and rectified flow."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``num`` evenly spaced float32 values, computed as the JAX package
    computes them: ``start·(1 − s) + stop·s`` with ``s = i · f32(1/div)``
    (XLA multiplies by the reciprocal of a constant divisor), and the
    endpoint appended exactly.  The DDIM timestep table cast from it
    matches the JAX one integer for integer."""
    if num == 1:
        return np.array([start], np.float32)
    div = num - 1
    s = np.arange(div, dtype=np.float32) * (np.float32(1) / np.float32(div))
    out = np.float32(start) * (np.float32(1) - s) + np.float32(stop) * s
    return np.concatenate([out, np.array([stop], np.float32)])


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Discrete-time DDPM. q(x_t | x_0) = N(sqrt(ā_t) x_0, (1-ā_t) I)."""

    num_train_steps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    kind: str = "linear"  # 'linear' | 'cosine'

    def betas(self, device=None) -> torch.Tensor:
        if self.kind == "linear":
            return torch.from_numpy(linspace_f32(
                self.beta_start, self.beta_end,
                self.num_train_steps)).to(device)
        t = torch.arange(self.num_train_steps + 1, dtype=torch.float32,
                         device=device) / self.num_train_steps
        f = torch.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        alpha_bar = f / f[0]
        return torch.clip(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999)

    def alpha_bars(self, device=None) -> torch.Tensor:
        return torch.cumprod(1.0 - self.betas(device), dim=0)

    def add_noise(self, x0, noise, t):
        """t: (B,) int in [0, num_train_steps)."""
        ab = self.alpha_bars(x0.device)[t]
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return (torch.sqrt(ab).reshape(shape) * x0
                + torch.sqrt(1 - ab).reshape(shape) * noise)


@dataclasses.dataclass(frozen=True)
class RectifiedFlowSchedule:
    """Rectified flow: x_t = (1-t) x0 + t·noise, velocity v = noise - x0."""

    timestep_shift: float = 1.0

    def interpolate(self, x0, noise, t):
        t = t.reshape((-1,) + (1,) * (x0.ndim - 1))
        return (1.0 - t) * x0 + t * noise

    def velocity_target(self, x0, noise):
        return noise - x0

    def sample_t(self, generator: torch.Generator, batch: int, device=None):
        t = torch.rand((batch,), generator=generator, device=device)
        s = self.timestep_shift
        return s * t / (1 + (s - 1) * t)

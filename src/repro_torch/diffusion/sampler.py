"""Samplers: DDIM (for DDPM-trained denoisers; the server's sampler for
vdit) and Euler rectified flow.  Every step's index feeds the Eq. 4
threshold schedule, so the model function receives (x_t, t, step).

``denoise_fn(x, t, step) -> eps/velocity`` closes over the model, the
text conditioning and the RippleConfig; samplers stay model-agnostic.
The loops are plain Python; ``step_offset`` / ``total_steps`` slice a
trajectory into chunks whose chaining repeats the single run exactly.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.diffusion.schedule import (DDPMSchedule,
                                            RectifiedFlowSchedule,
                                            linspace_f32)


def ddim_timesteps(schedule: DDPMSchedule, total: int) -> np.ndarray:
    """The integer timestep table of a ``total``-step DDIM run."""
    return linspace_f32(schedule.num_train_steps - 1, 0,
                        total).astype(np.int32)


@torch.no_grad()
def ddim_sample(denoise_fn: Callable, x_T: torch.Tensor,
                schedule: DDPMSchedule, num_steps: int, *, eta: float = 0.0,
                generator: Optional[torch.Generator] = None,
                step_offset: int = 0, total_steps: Optional[int] = None):
    """DDIM sampler. denoise_fn(x, t (B,) float, step_idx) -> eps.

    ``total_steps`` is the full schedule length and ``step_offset`` the
    steps already done: the timestep table is built from the total and
    indexed by absolute step.  With ``eta > 0`` fresh noise comes from
    ``generator``."""
    total = num_steps if total_steps is None else total_steps
    ts = ddim_timesteps(schedule, total)
    alpha_bars = schedule.alpha_bars(x_T.device)
    one = torch.ones((), device=x_T.device)
    B = x_T.shape[0]
    x = x_T
    for si in range(step_offset, step_offset + num_steps):
        t = int(ts[si])
        t_prev = int(ts[si + 1]) if si + 1 < total else -1
        ab_t = alpha_bars[t]
        ab_prev = alpha_bars[t_prev] if t_prev >= 0 else one
        eps = denoise_fn(x, torch.full((B,), float(t), device=x.device), si)
        x0 = (x - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
        sigma = eta * torch.sqrt((1 - ab_prev) / (1 - ab_t)) * \
            torch.sqrt(1 - ab_t / ab_prev)
        dir_xt = torch.sqrt(torch.clamp(1 - ab_prev - sigma ** 2, min=0.0)) \
            * eps
        x = torch.sqrt(ab_prev) * x0 + dir_xt
        if eta > 0:
            if generator is None:
                raise ValueError("eta > 0 needs a generator")
            x = x + sigma * torch.randn(x.shape, generator=generator,
                                        device=x.device, dtype=x.dtype)
    return x


@torch.no_grad()
def euler_flow_sample(denoise_fn: Callable, x_T: torch.Tensor,
                      num_steps: int, *,
                      schedule: Optional[RectifiedFlowSchedule] = None,
                      step_offset: int = 0,
                      total_steps: Optional[int] = None):
    """Euler ODE integration of rectified flow from t=1 (noise) to t=0.
    denoise_fn(x, t (B,), step_idx) -> velocity (noise - x0)."""
    total = num_steps if total_steps is None else total_steps
    ts = linspace_f32(1.0, 0.0, total + 1)
    B = x_T.shape[0]
    x = x_T
    for si in range(step_offset, step_offset + num_steps):
        t, t_next = ts[si], ts[si + 1]
        v = denoise_fn(x, torch.full((B,), float(t), device=x.device), si)
        x = x + float(np.float32(t_next - t)) * v
    return x

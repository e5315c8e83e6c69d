"""Samplers: DDIM (for DDPM-trained denoisers; the server's sampler for
vdit, dit and unet), Euler rectified flow (the server's sampler for the
mmdit) and the classifier-free-guidance wrapper.  Every step's index
feeds the Eq. 4 threshold schedule, so the model function receives
(x_t, t, step).

``denoise_fn(x, t, step) -> eps/velocity`` closes over the model, the
text conditioning and the RippleConfig; samplers stay model-agnostic.
The loops are plain Python; ``step_offset`` / ``total_steps`` slice a
trajectory into chunks whose chaining repeats the single run exactly.

Cross-step decision cache (DESIGN.md §13): pass ``decision_state`` (the
model's per-layer state, e.g. from ``launch.workloads.vdit_decision_state``)
and the contract becomes ``denoise_fn(x, t, step, state) -> (eps, state)``;
the sampler then returns ``(x, final_state)``, and a chunk's final state
is the next chunk's ``decision_state``.

Guardrails (DESIGN.md §17): with ``sentinel=True`` the sampler keeps a
running int32 count of non-finite latent entries, one ``isfinite`` pass
after each step, on the device (nothing is read back per step), and
appends it to the return: ``(x, nf)`` or ``(x, final_state, nf)``.
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
                step_offset: int = 0, total_steps: Optional[int] = None,
                decision_state=None, sentinel: bool = False):
    """DDIM sampler. denoise_fn(x, t (B,) float, step_idx) -> eps.

    ``total_steps`` is the full schedule length and ``step_offset`` the
    steps already done: the timestep table is built from the total and
    indexed by absolute step.  With ``eta > 0`` fresh noise comes from
    ``generator``.  With ``decision_state`` the denoiser carries it
    (``denoise_fn(x, t, step, state) -> (eps, state)``) and the sampler
    returns ``(x, final_state)``; ``sentinel`` appends the non-finite
    latent count (module doc)."""
    total = num_steps if total_steps is None else total_steps
    ts = ddim_timesteps(schedule, total)
    alpha_bars = schedule.alpha_bars(x_T.device)
    one = torch.ones((), device=x_T.device)
    B = x_T.shape[0]
    x = x_T
    nf = (torch.zeros((), dtype=torch.int32, device=x_T.device)
          if sentinel else None)
    for si in range(step_offset, step_offset + num_steps):
        t = int(ts[si])
        t_prev = int(ts[si + 1]) if si + 1 < total else -1
        ab_t = alpha_bars[t]
        ab_prev = alpha_bars[t_prev] if t_prev >= 0 else one
        t_b = torch.full((B,), float(t), device=x.device)
        if decision_state is None:
            eps = denoise_fn(x, t_b, si)
        else:
            eps, decision_state = denoise_fn(x, t_b, si, decision_state)
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
        if nf is not None:
            nf = nf + (~torch.isfinite(x)).sum().to(torch.int32)
    return _result(x, decision_state, nf)


def _result(x, decision_state, nf):
    """The samplers' return: x, then the final decision state when one is
    carried, then the non-finite count when the sentinel is on."""
    out = (x,) + (() if decision_state is None else (decision_state,)) \
        + (() if nf is None else (nf,))
    return out[0] if len(out) == 1 else out


@torch.no_grad()
def euler_flow_sample(denoise_fn: Callable, x_T: torch.Tensor,
                      num_steps: int, *,
                      schedule: Optional[RectifiedFlowSchedule] = None,
                      step_offset: int = 0,
                      total_steps: Optional[int] = None,
                      decision_state=None, sentinel: bool = False):
    """Euler ODE integration of rectified flow from t=1 (noise) to t=0.
    denoise_fn(x, t (B,), step_idx) -> velocity (noise - x0); with
    ``decision_state`` and ``sentinel`` as in :func:`ddim_sample`."""
    total = num_steps if total_steps is None else total_steps
    ts = linspace_f32(1.0, 0.0, total + 1)
    B = x_T.shape[0]
    x = x_T
    nf = (torch.zeros((), dtype=torch.int32, device=x_T.device)
          if sentinel else None)
    for si in range(step_offset, step_offset + num_steps):
        t, t_next = ts[si], ts[si + 1]
        t_b = torch.full((B,), float(t), device=x.device)
        if decision_state is None:
            v = denoise_fn(x, t_b, si)
        else:
            v, decision_state = denoise_fn(x, t_b, si, decision_state)
        x = x + float(np.float32(t_next - t)) * v
        if nf is not None:
            nf = nf + (~torch.isfinite(x)).sum().to(torch.int32)
    return _result(x, decision_state, nf)


def cfg_wrap(denoise_fn: Callable, guidance: float) -> Callable:
    """Classifier-free guidance: denoise_fn must accept ``cond`` batches
    stacked [uncond; cond] and return stacked outputs."""

    def wrapped(x, t, step):
        out = denoise_fn(torch.cat([x, x]), torch.cat([t, t]), step)
        un, co = torch.chunk(out, 2, dim=0)
        return un + guidance * (co - un)

    return wrapped

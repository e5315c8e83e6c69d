"""Adaptive per-denoising-step threshold schedule (paper Eq. 4).

* steps ``i < i_min`` and the final step run **dense** (θ = 0);
* on ``[i_min, i_max]`` the threshold ramps linearly θ_min → θ_max;
* after ``i_max`` it plateaus at θ_max.

Eq. 4 as printed ramps from zero and Tbl. 1's column headers are
swapped; this is the text's stated intent (DESIGN.md §5).  The port's
samplers are Python loops, so ``step`` is a host integer and θ a host
float.  The arithmetic runs in float32, op for op as the JAX package
does it, so both packages produce the same θ bit for bit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.config.base import RippleConfig

_F = np.float32


def threshold_for_step(cfg: RippleConfig, step: int, total_steps: int
                       ) -> float:
    """Shared threshold θ_i for denoising step ``step`` (0-based); 0.0
    (dense) outside the active range.  The value is a float32 number."""
    if cfg.fixed_threshold is not None:
        theta = _F(cfg.fixed_threshold)
    else:
        span = max(cfg.i_max - cfg.i_min, 1)
        ramp = (_F(cfg.theta_min) + (_F(step) - _F(cfg.i_min))
                * _F(cfg.theta_max - cfg.theta_min) / _F(span))
        theta = np.clip(ramp, _F(min(cfg.theta_min, cfg.theta_max)),
                        _F(max(cfg.theta_min, cfg.theta_max)))
    active = cfg.i_min <= step < total_steps - 1
    return float(theta) if active else 0.0


def axis_thresholds(cfg: RippleConfig, step: int, total_steps: int
                    ) -> Dict[str, float]:
    """Per-axis thresholds {θ_t, θ_x, θ_y} for one step; a per-axis
    override replaces the shared value while the schedule is on."""
    shared = threshold_for_step(cfg, step, total_steps)
    out = {}
    for axis, override in (("t", cfg.theta_t), ("x", cfg.theta_x),
                           ("y", cfg.theta_y)):
        if override is None:
            out[axis] = shared
        else:
            out[axis] = float(_F(override)) if shared > 0 else 0.0
    return out


def threshold_schedule(cfg: RippleConfig, total_steps: int) -> List[float]:
    """Shared thresholds for all steps (host-side inspection)."""
    return [threshold_for_step(cfg, i, total_steps)
            for i in range(total_steps)]

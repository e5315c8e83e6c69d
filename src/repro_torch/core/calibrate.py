"""Threshold calibration and the analytical step-sensitivity model.

The paper's knob is a *savings ratio* (TIMERIPPLE_75% / _85%): the
threshold is chosen so that reuse skips a target share of the partial
attention scores.  :func:`calibrate_threshold` bisects the shared θ on
sample Q/K activations to hit that target, as the Tbl. 1
hyper-parameters were found.

:func:`fit_step_sensitivity` is the Fig. 9 model: the MSE a fixed θ
induces decays with the denoising step; a line fitted in log space over
[i_min, i_max], inverted for constant MSE, gives the equal-impact
schedule (:func:`equal_mse_schedule`, the ``equal_mse`` policy).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.config.base import RippleConfig
from repro_torch.core import reuse as reuse_lib
from repro_torch.core import savings as savings_lib


def savings_at_threshold(q: torch.Tensor, k: torch.Tensor, grid,
                         cfg: RippleConfig, theta: float) -> float:
    """The paper-accounting savings of one shared θ on every axis."""
    thetas = {a: float(theta) for a in ("t", "x", "y")}
    kw = dict(axes=cfg.axes, window=cfg.window, granularity=cfg.granularity,
              channel_groups=cfg.channel_groups)
    rq = reuse_lib.compute_reuse(q, grid, thetas, **kw)
    rk = reuse_lib.compute_reuse(k, grid, thetas, **kw)
    return float(savings_lib.partial_score_savings(rq.mask, rk.mask))


def calibrate_threshold(q: torch.Tensor, k: torch.Tensor,
                        grid: Tuple[int, int, int], cfg: RippleConfig,
                        target_savings: float, lo: float = 0.0,
                        hi: float = 4.0, iters: int = 24,
                        tol: float = 5e-3) -> float:
    """Bisect the shared θ to reach ``target_savings`` on sample Q/K."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        s = savings_at_threshold(q, k, grid, cfg, mid)
        if abs(s - target_savings) < tol:
            return mid
        if s < target_savings:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def fit_step_sensitivity(steps, mses) -> Dict[str, float]:
    """Linear fit of log-MSE against step (the straight line of Fig. 9)."""
    steps = np.asarray(steps, np.float64)
    logm = np.log(np.maximum(np.asarray(mses, np.float64), 1e-30))
    A = np.stack([steps, np.ones_like(steps)], axis=1)
    coef, *_ = np.linalg.lstsq(A, logm, rcond=None)
    return {"slope": float(coef[0]), "intercept": float(coef[1])}


def equal_mse_schedule(fit: Dict[str, float],
                       mse_of_theta: Callable[[float, int], float],
                       i_min: int, i_max: int, theta_at_imin: float,
                       theta_hi: float = 4.0) -> np.ndarray:
    """Per-step θ inducing constant MSE across [i_min, i_max]: the target
    is the MSE ``theta_at_imin`` induces at i_min, and each step's θ is
    bisected against the measured ``mse_of_theta(θ, step)``."""
    target = mse_of_theta(theta_at_imin, i_min)
    thetas = []
    for i in range(i_min, i_max + 1):
        lo, hi = 0.0, theta_hi
        for _ in range(20):
            mid = 0.5 * (lo + hi)
            if mse_of_theta(mid, i) < target:
                lo = mid
            else:
                hi = mid
        thetas.append(0.5 * (lo + hi))
    return np.asarray(thetas)

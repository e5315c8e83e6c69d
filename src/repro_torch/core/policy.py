"""Pluggable reuse-policy registry — the *strategy* seam of the attention
dispatch layer (DESIGN.md §11).

A :class:`ReusePolicy` owns the per-step threshold schedule
(:meth:`ReusePolicy.thetas_for`) and the mask / snap decision
(:meth:`ReusePolicy.decide`, returning one :class:`ReuseDecision`);
``core.dispatch.attention_dispatch`` executes the planned backend on the
decision without knowing which strategy produced it.

Built-in policies of the port:

  ``ripple``  the paper: windowed Δ-checks snap Q/K entries to their
              window representative (Eq. 3/4 schedule, ``core.reuse``)
  ``dense``   no-op baseline; plans resolve straight to the dense backend
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import RippleConfig
from repro_torch.core import reuse as reuse_lib
from repro_torch.core import savings as savings_lib
from repro_torch.core.reuse import AXES
from repro_torch.core.schedule import axis_thresholds


@dataclasses.dataclass
class ReuseDecision:
    """What one policy decided for one attention call.

    ``q`` / ``k`` are the operands the backend executes on (snapped by
    operand-rewriting policies); ``bias`` is the additive logit bias;
    ``q_mask`` / ``k_mask`` are boolean snap masks (None for policies
    that never snap) and ``savings`` the paper-faithful savings of this
    call (a 0-d tensor on the operands' device).
    """

    q: torch.Tensor
    k: torch.Tensor
    thetas: Dict[str, float]
    bias: Optional[torch.Tensor] = None
    q_mask: Optional[torch.Tensor] = None
    k_mask: Optional[torch.Tensor] = None
    savings: Optional[torch.Tensor] = None


def zero_inactive_axes(thetas: Dict[str, float],
                       active_axes: Sequence[str]) -> Dict[str, float]:
    """Disable the Δ-check on axes outside ``active_axes`` (Δ ≥ 0, so a
    zero threshold never fires)."""
    out = dict(thetas)
    for a in AXES:
        if a not in active_axes:
            out[a] = 0.0
    return out


class ReusePolicy:
    """Base class of reuse policies.  The class attributes tell plan
    resolution what the policy needs:

      ``emits_bias``      decide() may attach a logit bias
      ``snaps_operands``  decide() may rewrite Q/K entries
      ``is_dense``        no-op baseline: plans resolve to 'dense'
    """

    name: str = ""
    emits_bias: bool = False
    snaps_operands: bool = True
    is_dense: bool = False

    def will_emit_bias(self, cfg: RippleConfig) -> bool:
        return self.emits_bias

    def thetas_for(self, cfg: RippleConfig, step, total_steps,
                   thetas: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
        return {a: 0.0 for a in AXES}

    def decide(self, q: torch.Tensor, k: torch.Tensor, *,
               grid: Tuple[int, int, int], cfg: RippleConfig,
               thetas: Dict[str, float],
               bias: Optional[torch.Tensor] = None,
               grid_slice: Optional[Tuple[int, int]] = None,
               fused: bool = False) -> ReuseDecision:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Snap helpers (the Fig. 6 step ①-② pipeline, fused or host-side per plan)
# ---------------------------------------------------------------------------


def _snap_segment(seg, grid, thetas, cfg: RippleConfig, active_axes,
                  use_fused: bool):
    """Step ①-② on one contiguous grid segment: the fused kernel when the
    plan asks for it and the shape qualifies, the host pipeline
    otherwise — bit-equal outputs either way."""
    if use_fused:
        from repro_torch.kernels.reuse_mask.ops import (fused_compute_reuse,
                                                        fused_reuse_eligible)
        if fused_reuse_eligible(grid, window=cfg.window,
                                granularity=cfg.granularity,
                                axes=active_axes):
            return fused_compute_reuse(seg.contiguous(), grid, thetas,
                                       axes=active_axes,
                                       granularity=cfg.granularity)
    r = reuse_lib.compute_reuse(
        seg, grid, thetas, axes=active_axes, window=cfg.window,
        granularity=cfg.granularity, channel_groups=cfg.channel_groups)
    return r.snapped, r.mask


def snap_operand(x, do: bool, grid, thetas, cfg: RippleConfig, active_axes,
                 grid_slice, use_fused: bool):
    """Snap one operand (or pass it through with an all-False mask when
    ``do`` is off).  ``grid_slice = (start, n)`` restricts snapping to the
    grid tokens of a mixed text+grid sequence.  Returns (snapped, mask)."""
    if not do:
        return x, torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if grid_slice is None:
        return _snap_segment(x, grid, thetas, cfg, active_axes, use_fused)
    s, n = grid_slice
    seg = x.narrow(-2, s, n)
    snapped_seg, mask_seg = _snap_segment(seg, grid, thetas, cfg,
                                          active_axes, use_fused)
    snapped = torch.cat([x.narrow(-2, 0, s), snapped_seg,
                         x.narrow(-2, s + n, x.shape[-2] - s - n)], dim=-2)
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    mask.narrow(-2, s, n).copy_(mask_seg)
    return snapped, mask


# ---------------------------------------------------------------------------
# Built-in policies
# ---------------------------------------------------------------------------


class RipplePolicy(ReusePolicy):
    """The paper's policy: Eq. 4 linear-ramp schedule + windowed Δ-check
    snapping on Q/K."""

    name = "ripple"

    def will_emit_bias(self, cfg):
        return self.emits_bias or cfg.svg_mask

    def thetas_for(self, cfg, step, total_steps, thetas=None):
        if thetas is None:
            if step is None or total_steps is None:
                raise ValueError("attention_dispatch needs explicit thetas "
                                 "or (step, total_steps)")
            thetas = axis_thresholds(cfg, int(step), int(total_steps))
        return zero_inactive_axes(thetas, tuple(cfg.axes))

    def decide(self, q, k, *, grid, cfg, thetas, bias=None, grid_slice=None,
               fused=False):
        if cfg.svg_mask:
            raise NotImplementedError(
                "the ripple+SVG combination waits for the block-sparse "
                "slice of the port")
        active_axes = tuple(cfg.axes)
        q_s, q_mask = snap_operand(q, cfg.snap_q, grid, thetas, cfg,
                                   active_axes, grid_slice, fused)
        k_s, k_mask = snap_operand(k, cfg.snap_k, grid, thetas, cfg,
                                   active_axes, grid_slice, fused)
        return ReuseDecision(
            q=q_s, k=k_s, thetas=thetas, bias=bias, q_mask=q_mask,
            k_mask=k_mask,
            savings=savings_lib.partial_score_savings(q_mask, k_mask))


class DensePolicy(ReusePolicy):
    """No-op baseline: every plan resolves to the dense backend."""

    name = "dense"
    snaps_operands = False
    is_dense = True

    def decide(self, q, k, *, grid, cfg, thetas, bias=None, grid_slice=None,
               fused=False):
        return ReuseDecision(q=q, k=k, thetas=thetas, bias=bias,
                             savings=torch.zeros((), device=q.device))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: "OrderedDict[str, ReusePolicy]" = OrderedDict()


def register_policy(policy: ReusePolicy, *, name: Optional[str] = None,
                    override: bool = False) -> ReusePolicy:
    """Register ``policy`` under ``name`` (default ``policy.name``); a
    registered name is valid as ``RippleConfig.policy``."""
    n = name or getattr(policy, "name", "")
    if not n or not isinstance(n, str):
        raise ValueError(f"policy {policy!r} needs a non-empty string name")
    if n in _REGISTRY and not override:
        raise ValueError(f"policy {n!r} already registered (pass "
                         f"override=True to replace it)")
    _REGISTRY[n] = policy
    return policy


def get_policy(name) -> ReusePolicy:
    """Look up a registered policy; ReusePolicy instances pass through."""
    if isinstance(name, ReusePolicy):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown reuse policy {name!r}; registered: "
                       f"{list_policies()}") from None


def list_policies() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


register_policy(RipplePolicy())
register_policy(DensePolicy())

"""Pluggable reuse-policy registry — the *strategy* seam of the attention
dispatch layer (DESIGN.md §11).

A :class:`ReusePolicy` owns the per-step threshold schedule
(:meth:`ReusePolicy.thetas_for`) and the mask / snap decision
(:meth:`ReusePolicy.decide`, returning one :class:`ReuseDecision`);
``core.dispatch.attention_dispatch`` executes the planned backend on the
decision without knowing which strategy produced it.

Built-in policies of the port:

  ``ripple``  the paper: windowed Δ-checks snap Q/K entries to their
              window representative (Eq. 3/4 schedule, ``core.reuse``);
              ``cfg.svg_mask`` composes the SVG block mask on top
  ``svg``     Sparse VideoGen-style head-classified spatial/temporal
              block masks (``core.svg_mask``) as a logit bias plus a
              tiled block map the sparse backend skips (DESIGN.md §12)
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
from repro_torch.core.svg_mask import svg_logit_bias


@dataclasses.dataclass
class ReuseDecision:
    """What one policy decided for one attention call.

    ``q`` / ``k`` are the operands the backend executes on (snapped by
    operand-rewriting policies); ``bias`` is the additive logit bias;
    ``q_mask`` / ``k_mask`` are boolean snap masks (None for policies
    that never snap) and ``savings`` the paper-faithful savings of this
    call (a 0-d tensor on the operands' device).

    ``block_map`` (DESIGN.md §12) is the per-(q_block, k_block) tile
    state map for the block-sparse backend — int32 skip/full/partial
    states broadcastable over (batch, heads), tiled with the
    ``block_shape`` the dispatcher passed to :meth:`ReusePolicy.decide`.
    None means every tile runs.
    """

    q: torch.Tensor
    k: torch.Tensor
    thetas: Dict[str, float]
    bias: Optional[torch.Tensor] = None
    q_mask: Optional[torch.Tensor] = None
    k_mask: Optional[torch.Tensor] = None
    savings: Optional[torch.Tensor] = None
    block_map: Optional[torch.Tensor] = None


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

      ``emits_bias``        decide() may attach a logit bias
      ``snaps_operands``    decide() may rewrite Q/K entries
      ``is_dense``          no-op baseline: plans resolve to 'dense'
      ``emits_block_map``   decide() can tile its mask into a sparse
                            block map (the block-sparse backend)
      ``caches_decisions``  the decision can be carried across steps
                            (the JAX package's decision cache, not
                            ported yet; serving refuses its settings)
    """

    name: str = ""
    emits_bias: bool = False
    snaps_operands: bool = True
    is_dense: bool = False
    emits_block_map: bool = False
    caches_decisions: bool = False

    def will_emit_bias(self, cfg: RippleConfig) -> bool:
        return self.emits_bias

    def will_emit_block_map(self, cfg: RippleConfig) -> bool:
        """Will decide() produce a ``ReuseDecision.block_map`` when given
        a ``block_shape``?  Plan resolution prefers the block-sparse
        backend for such policies."""
        return self.emits_block_map

    def thetas_for(self, cfg: RippleConfig, step, total_steps,
                   thetas: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
        return {a: 0.0 for a in AXES}

    def decide(self, q: torch.Tensor, k: torch.Tensor, *,
               grid: Tuple[int, int, int], cfg: RippleConfig,
               thetas: Dict[str, float],
               bias: Optional[torch.Tensor] = None,
               grid_slice: Optional[Tuple[int, int]] = None,
               fused: bool = False,
               block_shape: Optional[Tuple[int, int]] = None
               ) -> ReuseDecision:
        """``block_shape`` is the plan's (block_q, block_k), passed only
        when the block-sparse backend was planned for a map-emitting
        policy; such policies tile their masks with it."""
        raise NotImplementedError


def _keep_block_map(keep: torch.Tensor,
                    block_shape: Optional[Tuple[int, int]]):
    """Tile a boolean keep-mask into sparse-backend states, or None when
    the dispatcher did not plan the sparse backend (no ``block_shape``)."""
    if block_shape is None:
        return None
    from repro_torch.kernels.sparse.ops import block_map_from_keep

    return block_map_from_keep(keep, *block_shape)


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
    snapping on Q/K (``cfg.svg_mask`` additionally composes the SVG
    block mask on top, the TIMERIPPLE+SVG row of Tbl. 2)."""

    name = "ripple"
    caches_decisions = True

    def will_emit_bias(self, cfg):
        return self.emits_bias or cfg.svg_mask

    def will_emit_block_map(self, cfg):
        # The combination's block mask tiles into skip/full/partial
        # states, so the sparse backend can realize it (snapping still
        # happens; the pair-collapse win is traded away).
        return self.emits_block_map or cfg.svg_mask

    def thetas_for(self, cfg, step, total_steps, thetas=None):
        if thetas is None:
            if step is None or total_steps is None:
                raise ValueError("attention_dispatch needs explicit thetas "
                                 "or (step, total_steps)")
            thetas = axis_thresholds(cfg, int(step), int(total_steps))
        return zero_inactive_axes(thetas, tuple(cfg.axes))

    def decide(self, q, k, *, grid, cfg, thetas, bias=None, grid_slice=None,
               fused=False, block_shape=None):
        active_axes = tuple(cfg.axes)
        q_s, q_mask = snap_operand(q, cfg.snap_q, grid, thetas, cfg,
                                   active_axes, grid_slice, fused)
        k_s, k_mask = snap_operand(k, cfg.snap_k, grid, thetas, cfg,
                                   active_axes, grid_slice, fused)
        block_map = None
        if cfg.svg_mask:
            keep, bias = svg_logit_bias(q_s, k_s, grid, grid_slice, bias)
            block_map = _keep_block_map(keep, block_shape)
        return ReuseDecision(
            q=q_s, k=k_s, thetas=thetas, bias=bias, q_mask=q_mask,
            k_mask=k_mask,
            savings=savings_lib.partial_score_savings(q_mask, k_mask),
            block_map=block_map)


class SVGPolicy(ReusePolicy):
    """Sparse VideoGen-style structured masking: each head is classified
    online as spatial (frame-block-diagonal) or temporal
    (strided-diagonal) and the losing mask's blocks are dropped via a
    −inf logit bias.  Q/K are never rewritten."""

    name = "svg"
    emits_bias = True
    snaps_operands = False
    emits_block_map = True
    caches_decisions = True

    def decide(self, q, k, *, grid, cfg, thetas, bias=None, grid_slice=None,
               fused=False, block_shape=None):
        keep, bias, savings = svg_logit_bias(q, k, grid, grid_slice, bias,
                                             with_savings=True)
        return ReuseDecision(q=q, k=k, thetas=thetas, bias=bias,
                             savings=savings,
                             block_map=_keep_block_map(keep, block_shape))


class DensePolicy(ReusePolicy):
    """No-op baseline: every plan resolves to the dense backend."""

    name = "dense"
    snaps_operands = False
    is_dense = True

    def decide(self, q, k, *, grid, cfg, thetas, bias=None, grid_slice=None,
               fused=False, block_shape=None):
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
register_policy(SVGPolicy())
register_policy(DensePolicy())

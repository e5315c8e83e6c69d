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
  ``equal_mse``  ripple's decision with the Fig. 9 equal-impact per-step
              schedule (``core.calibrate``) instead of the linear ramp
  ``dense``   no-op baseline; plans resolve straight to the dense backend
  ``static``, ``rainfusion``  the offline-pattern policies of
              ``core.patterns`` (DESIGN.md §16), registered when this
              module is imported

Cache-capable policies (``caches_decisions``) also emit the cacheable
half of their decision with ``decide(want_plan=True)`` and re-apply a
cached one to fresh operands with :meth:`ReusePolicy.apply_decision`
(the cross-step decision cache, ``core.decision_cache``, DESIGN.md §13).
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
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

    ``q_src`` / ``k_src`` (only with ``want_plan=True``, DESIGN.md §13)
    are int32 snap-source token maps over the decided grid segment, the
    cacheable half of an operand-rewriting decision: re-applying one to
    fresh operands is one gather.
    """

    q: torch.Tensor
    k: torch.Tensor
    thetas: Dict[str, float]
    bias: Optional[torch.Tensor] = None
    q_mask: Optional[torch.Tensor] = None
    k_mask: Optional[torch.Tensor] = None
    savings: Optional[torch.Tensor] = None
    block_map: Optional[torch.Tensor] = None
    q_src: Optional[torch.Tensor] = None
    k_src: Optional[torch.Tensor] = None


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
      ``caches_decisions``  decide(want_plan=True) emits a reusable plan
                            (snap-source maps / bias / block map) that
                            :meth:`apply_decision` re-applies to fresh
                            operands: the cross-step decision cache
      ``plan_once``         a cache-capable policy whose decision is a
                            constant of the trajectory: the cache
                            refreshes at step 0 only (``static``)
    """

    name: str = ""
    emits_bias: bool = False
    snaps_operands: bool = True
    is_dense: bool = False
    emits_block_map: bool = False
    caches_decisions: bool = False
    plan_once: bool = False

    def will_emit_bias(self, cfg: RippleConfig) -> bool:
        return self.emits_bias

    def will_emit_block_map(self, cfg: RippleConfig) -> bool:
        """Will decide() produce a ``ReuseDecision.block_map`` when given
        a ``block_shape``?  Plan resolution prefers the block-sparse
        backend for such policies."""
        return self.emits_block_map

    def will_cache_decisions(self, cfg: RippleConfig) -> bool:
        """Can this policy's decision be cached across steps under this
        config?  The dispatcher passes ``want_plan=True`` to decide(),
        and calls :meth:`apply_decision` on cache hits, only then."""
        return self.caches_decisions

    def will_seq_shard(self, cfg: RippleConfig) -> bool:
        """Does the context-parallel ring (``core.ring``, DESIGN.md §14)
        know how to run this policy's decision shard-locally when the
        token axis is sharded over a ``seq`` mesh axis?  Policies that
        return False fall back to the replicated token axis (batch/head
        sharding still applies): the ring never guesses."""
        return False

    def plan_token(self, cfg: Optional[RippleConfig] = None):
        """Hashable token of the outside state this policy's decisions
        depend on (the pattern artifact's version, DESIGN.md §16).  The
        dispatch plan key and the serving bucket key carry it, so a swap
        of that state gets a plan and a sampler of its own.  None when
        the policy has no such state."""
        return None

    def thetas_for(self, cfg: RippleConfig, step, total_steps,
                   thetas: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
        return {a: 0.0 for a in AXES}

    def calibrate(self, q: torch.Tensor, k: torch.Tensor,
                  grid: Tuple[int, int, int], cfg: RippleConfig,
                  target_savings: float) -> Dict[str, object]:
        """Fit strategy parameters on sample Q/K; returns RippleConfig
        field overrides (possibly empty)."""
        return {}

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
        policy; such policies tile their masks with it.  Cache-capable
        policies also take ``want_plan`` and then fill
        ``ReuseDecision.q_src`` / ``k_src``."""
        raise NotImplementedError

    def apply_decision(self, q: torch.Tensor, k: torch.Tensor, cached, *,
                       grid: Tuple[int, int, int], cfg: RippleConfig,
                       thetas: Dict[str, float],
                       grid_slice: Optional[Tuple[int, int]] = None,
                       block_shape: Optional[Tuple[int, int]] = None
                       ) -> ReuseDecision:
        """Re-apply a cached decision (a
        :class:`~repro_torch.core.decision_cache.CachedDecision` that an
        earlier ``decide(want_plan=True)`` made on operands of the same
        shapes) to *fresh* operands: snap-source maps are replayed as one
        gather each, the cached bias and block map attached as they are.
        Only the decision is stale; the per-step math stays exact.
        ``block_shape`` is the one that ``decide`` took."""
        q_s, q_mask = replay_snap(q, cached.q_idx, grid_slice,
                                  self.snaps_operands)
        k_s, k_mask = replay_snap(k, cached.k_idx, grid_slice,
                                  self.snaps_operands)
        if q_mask is not None and k_mask is not None:
            sav = savings_lib.partial_score_savings(q_mask, k_mask)
        elif cached.bias is not None:
            # mask policies: skippable score fraction = masked density
            kept = torch.count_nonzero(cached.bias >= 0.0)
            sav = 1.0 - kept.float() / cached.bias.numel()
        else:
            sav = torch.zeros((), device=q.device)
        return ReuseDecision(
            q=q_s, k=k_s, thetas=thetas, bias=cached.bias, q_mask=q_mask,
            k_mask=k_mask, savings=sav, block_map=cached.block_map,
            q_src=cached.q_idx, k_src=cached.k_idx)


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


def snap_operand(x, do: bool, grid, thetas, cfg: RippleConfig, active_axes,
                 grid_slice, use_fused: bool, want_src: bool = False):
    """Snap one operand (or pass it through with an all-False mask when
    ``do`` is off).  ``grid_slice = (start, n)`` restricts snapping to the
    grid tokens of a mixed text+grid sequence.  The fused kernel runs
    when the plan asks for it and the shape qualifies: one launch on the
    whole operand, text tokens copied through, and with ``want_src`` the
    grid segment's snap-source map from the same launch.  Otherwise the
    host pipeline runs on the grid tokens; the outputs are bit-equal
    either way.  Returns (snapped, mask), and with ``want_src`` the
    source map (None when ``do`` is off)."""
    if not do:
        out = (x, torch.zeros(x.shape, dtype=torch.bool, device=x.device))
        return out + ((None,) if want_src else ())
    if use_fused:
        from repro_torch.kernels.reuse_mask.ops import (fused_compute_reuse,
                                                        fused_reuse_eligible)
        if fused_reuse_eligible(grid, window=cfg.window,
                                granularity=cfg.granularity,
                                axes=active_axes):
            return fused_compute_reuse(x, grid, thetas, axes=active_axes,
                                       granularity=cfg.granularity,
                                       grid_slice=grid_slice,
                                       want_src=want_src)
    return reuse_lib.snap_grid_tokens(
        x, grid, thetas, grid_slice, want_src=want_src, axes=active_axes,
        window=cfg.window, granularity=cfg.granularity,
        channel_groups=cfg.channel_groups)


def replay_snap(x, src, grid_slice, snaps_operands: bool):
    """Re-apply a cached snap-source map to a fresh operand: one gather
    over the grid segment; text tokens pass through untouched and the
    mask is ``src != own token``.  Returns (snapped, mask); with ``src``
    None the operand passes through (an all-False mask for snapping
    policies, no mask otherwise, as the matching decide() gives)."""
    if src is None:
        return x, (torch.zeros(x.shape, dtype=torch.bool, device=x.device)
                   if snaps_operands else None)
    s, n = grid_slice if grid_slice is not None else (0, x.shape[-2])
    own = torch.arange(n, dtype=src.dtype, device=src.device)[:, None]
    seg = torch.gather(x.narrow(-2, s, n), -2, src)
    if grid_slice is None:
        return seg, src != own
    snapped = torch.cat([x.narrow(-2, 0, s), seg,
                         x.narrow(-2, s + n, x.shape[-2] - s - n)], dim=-2)
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    mask.narrow(-2, s, n).copy_(src != own)
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

    def will_seq_shard(self, cfg):
        # Pure snapping shards cleanly (the halo exchange covers the
        # window); the +SVG combination would need the mask and snap
        # paths fused on the ring, which the ring does not do.
        return not cfg.svg_mask

    def thetas_for(self, cfg, step, total_steps, thetas=None):
        if thetas is None:
            if step is None or total_steps is None:
                raise ValueError("attention_dispatch needs explicit thetas "
                                 "or (step, total_steps)")
            thetas = axis_thresholds(cfg, int(step), int(total_steps))
        return zero_inactive_axes(thetas, tuple(cfg.axes))

    def calibrate(self, q, k, grid, cfg, target_savings):
        from repro_torch.core.calibrate import calibrate_threshold

        theta = calibrate_threshold(q, k, grid, cfg, target_savings)
        return {"fixed_threshold": theta}

    def decide(self, q, k, *, grid, cfg, thetas, bias=None, grid_slice=None,
               fused=False, block_shape=None, want_plan=False):
        active_axes = tuple(cfg.axes)

        def snap(x, do):
            out = snap_operand(x, do, grid, thetas, cfg, active_axes,
                               grid_slice, fused, want_src=want_plan)
            return out if want_plan else out + (None,)

        q_s, q_mask, q_src = snap(q, cfg.snap_q)
        k_s, k_mask, k_src = snap(k, cfg.snap_k)
        block_map = None
        if cfg.svg_mask:
            keep, bias = svg_logit_bias(q_s, k_s, grid, grid_slice, bias)
            block_map = _keep_block_map(keep, block_shape)
        return ReuseDecision(
            q=q_s, k=k_s, thetas=thetas, bias=bias, q_mask=q_mask,
            k_mask=k_mask,
            savings=savings_lib.partial_score_savings(q_mask, k_mask),
            block_map=block_map, q_src=q_src, k_src=k_src)


def _fma32(a, b, c) -> np.float32:
    """float32 a * b + c rounded once: the product is exact in float64,
    and the float64 sum's rounding error breaks a float32 tie."""
    p = float(a) * float(b)
    s = p + float(c)
    bb = s - p
    err = (p - (s - bb)) + (float(c) - bb)
    r = np.float32(s)
    if err != 0 and float(r) != s:
        other = np.nextafter(r, np.float32(np.inf if s > float(r)
                                           else -np.inf))
        if s == (float(r) + float(other)) / 2:
            r = max(r, other) if err > 0 else min(r, other)
    return np.float32(r)


_EXP_POLY = tuple(np.float32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def _exp_f32(x) -> np.float32:
    """float32 exp(x) for |x| < 80 as the JAX package's CPU backend
    evaluates it (Cephes' range reduction and degree-6 polynomial with
    fused multiply-adds), so an ``equal_mse`` θ equals the reference's
    bit for bit; a correctly rounded exp differs from it in about one
    argument in ten by an ulp."""
    f32 = np.float32
    x = f32(x)
    m = f32(math.floor(_fma32(x, f32(1.44269504088896341), f32(0.5))))
    r = _fma32(m, f32(-0.693359375), x)
    r = _fma32(m, f32(2.12194440e-4), r)
    y = _EXP_POLY[0]
    for c in _EXP_POLY[1:]:
        y = _fma32(y, r, c)
    y = f32(_fma32(y, f32(r * r), r) + f32(1))
    return f32(np.ldexp(y, int(m)))


class EqualMSEPolicy(RipplePolicy):
    """Ripple's decision under the Fig. 9 equal-impact schedule.

    The analytical step-sensitivity model (``core.calibrate``): the MSE a
    fixed θ induces decays log-linearly in the denoising step, and at a
    fixed step grows ~θ², so holding it at its i_min level gives

        θ_i = θ_min · exp(−slope · (i − i_min) / 2)

    clipped to [θ_min, θ_max], in float32 as the JAX package computes
    it (:func:`_exp_f32`).  A table calibrated offline by ``equal_mse_schedule`` overrides
    the analytic form (:meth:`from_schedule`).
    """

    name = "equal_mse"

    def __init__(self, mse_slope: float = -0.15,
                 theta_table: Optional[np.ndarray] = None,
                 table_i_min: Optional[int] = None):
        self.mse_slope = float(mse_slope)
        self.theta_table = (None if theta_table is None
                            else np.asarray(theta_table, np.float32))
        self.table_i_min = table_i_min

    @classmethod
    def from_schedule(cls, thetas: np.ndarray, i_min: int,
                      name: Optional[str] = None) -> "EqualMSEPolicy":
        """Wrap a per-step θ table from ``calibrate.equal_mse_schedule``."""
        pol = cls(theta_table=thetas, table_i_min=i_min)
        if name is not None:
            pol.name = name
        return pol

    def _shared_theta(self, cfg: RippleConfig, step: int,
                      total_steps: int) -> float:
        i_min = (self.table_i_min if self.table_i_min is not None
                 else cfg.i_min)
        if not i_min <= step < total_steps - 1:
            return 0.0
        if self.theta_table is not None:
            idx = min(max(step - i_min, 0), self.theta_table.shape[0] - 1)
            return float(self.theta_table[idx])
        f32 = np.float32
        lo = f32(min(cfg.theta_min, cfg.theta_max))
        hi = f32(max(cfg.theta_min, cfg.theta_max))
        ramp = f32(cfg.theta_min) * _exp_f32(
            f32(-0.5 * self.mse_slope) * (f32(step) - f32(i_min)))
        return float(np.clip(ramp, lo, hi))

    def thetas_for(self, cfg, step, total_steps, thetas=None):
        if thetas is None:
            if step is None or total_steps is None:
                raise ValueError("equal_mse needs explicit thetas or "
                                 "(step, total_steps)")
            shared = self._shared_theta(cfg, int(step), int(total_steps))
            thetas = {a: shared for a in AXES}
        return zero_inactive_axes(thetas, tuple(cfg.axes))


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

    def will_seq_shard(self, cfg):
        # Head classification has a sharded twin (classify_heads_sharded)
        # and the masks are row-separable, so each shard rebuilds its own
        # bias rows exactly.
        return True

    def decide(self, q, k, *, grid, cfg, thetas, bias=None, grid_slice=None,
               fused=False, block_shape=None, want_plan=False):
        # The whole decision is the (bias, block_map) pair, which the
        # cache carries as it is: a cache hit skips the head
        # classification and mask building (no want_plan work needed).
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
register_policy(EqualMSEPolicy())
register_policy(DensePolicy())

# The pattern-search policies (``static``, ``rainfusion``) live in
# core/patterns.py and register themselves on import; importing here
# makes every registry consumer see them, as in the JAX package.
from repro_torch.core import patterns as _patterns  # noqa: E402,F401

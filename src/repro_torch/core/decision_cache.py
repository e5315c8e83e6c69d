"""Cross-step reuse-decision cache (DESIGN.md §13).

The reuse decision (windowed Δ-checks on three axes and their snap
masks, or the SVG head classification and its block mask) barely
changes between adjacent denoising steps, so it need not be made again
on every attention call of every step.  Only the *decision* is carried:
the cached plan is re-applied to the **fresh** Q/K of each step, so the
per-step math stays exact.

The cacheable plan of one :class:`~repro_torch.core.policy.ReuseDecision`
is a :class:`CachedDecision`:

  * ``q_idx`` / ``k_idx`` — snap-source token maps (operand-rewriting
    policies); replaying one is a single gather,
  * ``bias`` / ``block_map`` — mask-emitting policies, reused as they
    are, so a cache hit skips the head classification entirely,
  * ``ref_stat`` — the sampled-channel Δ statistic recorded when the
    decision was made, per (batch, head) cell,
  * ``hits`` / ``refreshes`` — per-cell counters for serving telemetry,
  * ``elided`` — the ring's elided-hop counters (DESIGN.md §14).

A decision is made again when ``step % cfg.reuse_every == 0``, on the
final denoising step, or, with ``cfg.drift_tol > 0``, when the drift
statistic of the fresh operands moved more than ``drift_tol`` (relative)
from ``ref_stat``.  The step and the cadence are host integers, so the
cadence test reads nothing from the device; the drift guard reads one
device bool per call (``core.dispatch._run_pipeline_cached``).

Field names, shapes and dtypes are the JAX package's, so a state crosses
between the two through :func:`state_to_arrays`.  A model keeps one
state per layer in a list (None until the layer's first refresh; step 0
always refreshes); :func:`stack_layers` gives the JAX package's
layer-stacked form.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config.base import RippleConfig
from repro_torch.core.policy import ReuseDecision, get_policy

__all__ = ["CachedDecision", "bump_hit", "cache_from_decision",
           "drift_stat", "merge_states", "refresh_due", "slice_state",
           "stack_layers", "state_from_arrays", "state_to_arrays",
           "supports_cache", "unstack_layers"]


@dataclasses.dataclass
class CachedDecision:
    """The plan half of one reuse decision (see the module doc).  Every
    tensor keeps the operands' leading (batch, head) dims but
    ``elided``: on the context-parallel ring (``core.ring``) each seq
    shard's running count of ring hops it skipped as all-SKIP, int32 of
    shape (S,) (one entry a shard, as the reference's), None elsewhere;
    there ``ref_stat`` / ``hits`` / ``refreshes`` are (..., S), a
    column a shard.  The guardrail
    sentinels (``core.guardrail.attach_sentinel``, with ``cfg.sentinel``
    on) fill ``nonfinite``, the running count of non-finite attention
    outputs, and ``probe_err``, the largest dense-probe relative error;
    both are None otherwise and carry across refreshes."""

    q_idx: Optional[torch.Tensor] = None      # int32 (..., Ng, d)
    k_idx: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None       # f32 additive logit mask
    block_map: Optional[torch.Tensor] = None  # int32 (..., nq, nk)
    ref_stat: Optional[torch.Tensor] = None   # f32 lead-shaped
    hits: Optional[torch.Tensor] = None       # int32 lead-shaped
    refreshes: Optional[torch.Tensor] = None
    elided: Optional[torch.Tensor] = None
    nonfinite: Optional[torch.Tensor] = None  # int32 lead-shaped
    probe_err: Optional[torch.Tensor] = None  # f32 lead-shaped


_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(CachedDecision))


def supports_cache(cfg: RippleConfig, policy=None) -> bool:
    """Can dispatch carry decisions across steps for this config?  The
    config must be active and the resolved policy must declare the
    capability."""
    if not cfg.active():
        return False
    pol = get_policy(policy if policy is not None else cfg.policy)
    return (not pol.is_dense) and pol.will_cache_decisions(cfg)


def drift_stat(q: torch.Tensor, k: torch.Tensor,
               cfg: RippleConfig) -> torch.Tensor:
    """Cheap sampled-channel Δ statistic, one float32 per leading
    (batch, head) cell: the mean |adjacent-token difference| over a
    strided sample of ``cfg.drift_channels`` channels of Q and K."""
    c = max(int(cfg.drift_channels), 1)

    def stat(x):
        stride = max(x.shape[-1] // c, 1)
        xs = x[..., ::stride].float()
        return (xs[..., 1:, :] - xs[..., :-1, :]).abs().mean(dim=(-1, -2))

    return 0.5 * (stat(q) + stat(k))


def refresh_due(step: int, cfg: RippleConfig, stat: Optional[torch.Tensor],
                ref_stat: Optional[torch.Tensor],
                total_steps: Optional[int] = None) -> bool:
    """Is the cached decision stale at ``step``?  Due on the
    ``reuse_every`` cadence, always on the final denoising step (the
    Eq. 4 schedule runs it dense), and, with the drift guard on, when any
    (batch, head) cell's statistic moved more than ``drift_tol``
    relative to the cached reference.  The cadence is decided on the
    host; only the drift test reads the device, one bool."""
    every = max(int(cfg.reuse_every), 1)
    step = int(step)
    if step % every == 0:
        return True
    if total_steps is not None and step >= int(total_steps) - 1:
        return True
    if cfg.drift_tol > 0 and ref_stat is not None:
        rel = (stat - ref_stat).abs() > cfg.drift_tol * (ref_stat.abs()
                                                         + 1e-6)
        return bool(rel.any())  # the one device read of the guard
    return False


def cache_from_decision(decision: ReuseDecision, stat: torch.Tensor,
                        prev: Optional[CachedDecision] = None
                        ) -> CachedDecision:
    """The cacheable plan of a fresh ``decide(want_plan=True)``, with the
    refresh counter bumped (``prev=None`` starts the counters) and the
    sentinel leaves of ``prev`` carried on."""
    if prev is None or prev.hits is None:
        hits = torch.zeros(stat.shape, dtype=torch.int32, device=stat.device)
        refreshes = torch.ones(stat.shape, dtype=torch.int32,
                               device=stat.device)
    else:
        hits, refreshes = prev.hits, prev.refreshes + 1
    return CachedDecision(
        q_idx=decision.q_src, k_idx=decision.k_src, bias=decision.bias,
        block_map=decision.block_map, ref_stat=stat, hits=hits,
        refreshes=refreshes,
        nonfinite=None if prev is None else prev.nonfinite,
        probe_err=None if prev is None else prev.probe_err)


def bump_hit(cached: CachedDecision) -> CachedDecision:
    """The cache hit's counter update."""
    return dataclasses.replace(cached, hits=cached.hits + 1)


def stack_layers(states: Sequence[CachedDecision]) -> CachedDecision:
    """Per-layer states stacked on a new leading layer dim: the JAX
    package's layer-stacked state for the same run."""
    out = {}
    for name in _STATE_FIELDS:
        leaves = [getattr(s, name) for s in states]
        out[name] = None if leaves[0] is None else torch.stack(leaves)
    return CachedDecision(**out)


def unstack_layers(state: CachedDecision) -> List[CachedDecision]:
    """The per-layer list of a layer-stacked state (:func:`stack_layers`'
    inverse): the model's form of the JAX package's state."""
    n = next(getattr(state, f) for f in _STATE_FIELDS
             if getattr(state, f) is not None).shape[0]
    return [CachedDecision(**{
        name: None if getattr(state, name) is None else getattr(state, name)[i]
        for name in _STATE_FIELDS}) for i in range(n)]


# -- checkpoint (de)serialization -----------------------------------------
#
# A serving engine persists the decision state at chunk boundaries so a
# restart can resume with the same cached plan.  Leaves cross the disk
# boundary as host arrays keyed by field name (numpy from
# state_to_arrays; the checkpoint store reads them back as tensors).


def state_to_arrays(state: CachedDecision) -> Dict[str, Optional[np.ndarray]]:
    """Host-array mapping of every leaf (None leaves stay None)."""
    return {name: (None if getattr(state, name) is None
                   else getattr(state, name).detach().cpu().numpy())
            for name in _STATE_FIELDS}


def state_from_arrays(arrays, device=None) -> CachedDecision:
    """Inverse of :func:`state_to_arrays`, onto ``device``, from numpy
    arrays or tensors; unknown keys are refused, so a checkpoint of
    another code version fails loudly."""
    extra = set(arrays) - set(_STATE_FIELDS)
    if extra:
        raise ValueError(f"unknown CachedDecision fields in checkpoint: "
                         f"{sorted(extra)}")
    return CachedDecision(**{
        name: (None if arrays.get(name) is None
               else torch.as_tensor(arrays[name], device=device))
        for name in _STATE_FIELDS})


def slice_state(state: CachedDecision, index: int,
                batch_axis: int = 1) -> CachedDecision:
    """One request's slice of a batched (layer-stacked) state: every leaf
    keeps entry ``index`` of ``batch_axis`` as a size-1 dim, so
    :func:`merge_states` is its exact inverse."""
    if state.elided is not None:
        raise ValueError("cannot slice a context-parallel (ring) decision "
                         "state per request")
    return CachedDecision(**{
        name: (None if getattr(state, name) is None
               else getattr(state, name).narrow(batch_axis, index, 1))
        for name in _STATE_FIELDS})


def merge_states(states: Sequence[CachedDecision],
                 batch_axis: int = 1) -> CachedDecision:
    """Concatenate per-request states back into one batched state.  Leaf
    presence must agree across the inputs."""
    states: List[CachedDecision] = list(states)
    if not states:
        raise ValueError("merge_states needs at least one state")
    out = {}
    for name in _STATE_FIELDS:
        leaves = [getattr(s, name) for s in states]
        nones = [lf is None for lf in leaves]
        if all(nones):
            out[name] = None
        elif any(nones):
            raise ValueError(f"checkpoint states disagree on field "
                             f"{name!r} (some None, some not)")
        else:
            out[name] = (leaves[0] if len(leaves) == 1
                         else torch.cat(leaves, dim=batch_axis))
    return CachedDecision(**out)

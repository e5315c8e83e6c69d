"""Context-parallel ring attention over the ``seq`` mesh axis (DESIGN.md §14).

The batch/head sharding of §10 cannot split a *single* long or
high-resolution video.  This module runs the reuse pipeline with the
token axis sharded ``S`` ways over a third mesh axis, inside the
dispatcher's ``spmd.shard_map`` (one thread a shard, DESIGN.md §10):

* **Decision path** — shard-local, with an explicit halo.  When a shard
  boundary cuts a reuse window, each shard ``ppermute``-exchanges
  ``window − 1`` neighbour frames, runs the windowed Δ-checks again on a
  window-aligned slab of ``lmax`` frames and keeps its own rows: bit
  for bit the single-device decision (``t_valid`` masks the global tail
  and the ring-wrapped windows; x/y windows lie inside a frame and need
  no halo).  When ``T/S`` is a window multiple (or t is inactive) the
  halo is empty and the slab is the local block itself.

* **Execution path**, two backends:

  - ``reference`` (snap policies: ripple, equal_mse), the exactness
    path: the snapped Q, K and V are all-gathered and every shard runs
    the full-shape dense attention and keeps its query rows, the same
    computation as on one device, so bit for bit.
  - ``sparse`` (mask policies: svg, static), the true ring: K/V blocks
    rotate with ``ppermute`` while the block-sparse kernel carries its
    online-softmax state ``(m, l, acc)`` across hops
    (``kernels.sparse``'s ``carry``).  Per hop the shard slices its bias
    rows down to the arriving key block, tiles them into a block map and
    **skips the whole hop** (no kernel launch) when every tile is SKIP;
    the count rides the decision cache's ``elided`` leaf.  The rotation
    still runs every hop (the next shards need the blocks), so the
    saving is compute, not communication.  Hop order rotates the softmax
    reduction per shard, so outputs match one device to ~1e-5 relative,
    not bit for bit.

Collectives (halo exchange, sharded head classification, the rotation)
always run outside the decision cache's refresh choice: a shard decides
to refresh on its own, and no shard's refresh can desync the others
(§13 extended to seq).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.config.base import RippleConfig
from repro_torch.core import reuse as reuse_lib
from repro_torch.core.decision_cache import CachedDecision
from repro_torch.core.svg_mask import classify_heads_sharded, svg_keep_rows
from repro_torch.distributed import spmd
from repro_torch.distributed.spmd import P

__all__ = ["SEQ_AXIS", "ring_cache_specs", "ring_pipeline"]

SEQ_AXIS = "seq"


# ---------------------------------------------------------------------------
# Halo geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """Shard-slab geometry for one (grid, window, S) combination.

    ``left = window − 1`` neighbour frames cover every window a shard
    boundary can cut; the slab is the smallest window-aligned frame range
    holding the local block, so ``lmax = w·⌈(left + tl)/w⌉`` and
    ``right = lmax − tl``."""

    t_local: int
    hw: int
    window: int
    left: int
    right: int
    lmax: int

    @property
    def fast(self) -> bool:
        return self.left == 0 and self.right == 0


def _geometry(grid, cfg: RippleConfig, shards: int) -> _Geometry:
    T, H, W = grid
    w = max(int(cfg.window), 1)
    tl = T // shards
    if "t" not in cfg.axes or w <= 1 or tl % w == 0:
        return _Geometry(tl, H * W, w, 0, 0, tl)
    left = w - 1
    lmax = w * math.ceil((left + tl) / w)
    return _Geometry(tl, H * W, w, left, lmax - tl, lmax)


def _ppermute(x: torch.Tensor, shards: int, shift: int) -> torch.Tensor:
    """Rotate along the ring: with ``shift=+1`` every shard receives its
    left neighbour's buffer (shard ``j`` sends to ``j + 1``)."""
    perm = [(j, (j + shift) % shards) for j in range(shards)]
    return spmd.ppermute(x, SEQ_AXIS, perm)


def _phase(geom: _Geometry) -> int:
    """The local block's frame offset inside its window-aligned slab."""
    return (spmd.axis_index(SEQ_AXIS) * geom.t_local) % geom.window


def _halo_slab(x: torch.Tensor, geom: _Geometry, shards: int):
    """(..., N_local, d) tokens -> ``(slab, o0)``: the window-aligned
    decision slab and the local block's token offset in it (0 on the
    fast path).  A window wider than a shard pulls whole neighbour
    blocks (several hops)."""
    if geom.fast:
        return x, 0
    nl = x.shape[-2]
    left_t = geom.left * geom.hw
    right_t = geom.right * geom.hw

    segs, cur = [], x
    for _ in range(-(-left_t // nl)):
        cur = _ppermute(cur, shards, +1)
        segs.insert(0, cur)
    lbuf = torch.cat(segs, dim=-2)[..., -left_t:, :]

    segs, cur = [], x
    for _ in range(-(-right_t // nl)):
        cur = _ppermute(cur, shards, -1)
        segs.append(cur)
    rbuf = torch.cat(segs, dim=-2)[..., :right_t, :]

    ext = torch.cat([lbuf, x, rbuf], dim=-2)
    p = _phase(geom)
    slab = ext.narrow(-2, (geom.left - p) * geom.hw, geom.lmax * geom.hw)
    return slab, p * geom.hw


def _t_valid(geom: _Geometry, grid, device) -> Optional[torch.Tensor]:
    """(lmax,) bool: slab frames whose t-window lies inside [0, T).  It
    gates the global remainder tail (those frames never t-snap, as on one
    device) and the last shard's ring-wrapped right halo.  None on the
    fast path: every window is then in range."""
    if geom.fast:
        return None
    g0 = spmd.axis_index(SEQ_AXIS) * geom.t_local
    j = torch.arange(geom.lmax, device=device)
    win_start = g0 - (g0 % geom.window) + (j // geom.window) * geom.window
    return (win_start + geom.window) <= grid[0]


# ---------------------------------------------------------------------------
# Shard-local decisions
# ---------------------------------------------------------------------------


def _decide_src(x, geom: _Geometry, grid, thetas, cfg: RippleConfig, o0,
                t_valid):
    """Windowed Δ-checks on the slab; the slab-coordinate snap-source map
    of the local rows, (..., N_local, d) int32: the cacheable half of the
    decision (a replay is one gather, §13)."""
    T, H, W = grid
    r = reuse_lib.compute_reuse(
        x, (geom.lmax, H, W), thetas, axes=tuple(cfg.axes),
        window=cfg.window, granularity=cfg.granularity,
        channel_groups=cfg.channel_groups, want_src=True, t_valid=t_valid)
    nl = geom.t_local * geom.hw
    return r.src_idx.narrow(-2, o0, nl)


def _gather_src(slab, src):
    return torch.gather(slab, -2, src)


def _pack(stat):
    """(B, H) shard-local statistic -> (B, H, 1) cache leaf, so the seq
    axis has a dim to live on (global shape (B, H, S))."""
    return stat[..., None]


def _counters(prev: Optional[CachedDecision], stat):
    if prev is None or prev.hits is None:
        return (torch.zeros(stat.shape + (1,), dtype=torch.int32,
                            device=stat.device),
                torch.ones(stat.shape + (1,), dtype=torch.int32,
                           device=stat.device))
    return prev.hits, prev.refreshes + 1


def _drift(q, k, cfg: RippleConfig):
    from repro_torch.core import decision_cache as dc

    if cfg.drift_tol > 0:
        return dc.drift_stat(q, k, cfg)
    return torch.zeros(q.shape[:-2], dtype=torch.float32, device=q.device)


def _refresh(step, cfg, stat, cached, total_steps) -> bool:
    from repro_torch.core import decision_cache as dc

    return dc.refresh_due(step, cfg, stat, cached.ref_stat[..., 0],
                          total_steps)


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------


def _reference_ring_execute(q_s, k_s, v, scale):
    """The exactness path of the snap policies: gather the snapped
    operands and run the *full-shape* dense attention on every shard,
    keeping the local query rows.  Gathering only K/V and computing the
    local rows would be right but not bit for bit (a matmul of another
    row count may round differently); the same shapes run the same
    computation, which is the reference backend's bitwise contract."""
    from repro_torch.core.dispatch import dense_attention

    ax = q_s.ndim - 2
    nl = q_s.shape[-2]
    qb = spmd.all_gather(q_s, SEQ_AXIS, ax)
    kb = spmd.all_gather(k_s, SEQ_AXIS, ax)
    vb = spmd.all_gather(v, SEQ_AXIS, ax)
    full = dense_attention(qb, kb, vb, scale, None)
    return full.narrow(ax, spmd.axis_index(SEQ_AXIS) * nl, nl)


def _sparse_ring_execute(q, k, v, bias_rows, plan, shards: int):
    """The true ring: rotate K/V blocks, carry the online-softmax state
    through the block-sparse kernel, and skip a hop outright (no launch)
    when its block-map slice is all-SKIP.  Returns ``(out, elided)``, the
    number of hops this shard skipped in this call."""
    from repro_torch.kernels.sparse.ops import (SKIP, block_map_from_keep,
                                                sparse_attention)
    from repro_torch.kernels.sparse.ref import finalize, fresh_state

    B, H, nl, _ = q.shape
    me = spmd.axis_index(SEQ_AXIS)
    state = fresh_state((B, H), nl, v.shape[-1], q.device)
    elided = 0
    k_cur, v_cur = k, v
    for h in range(shards):
        src = (me - h) % shards  # whose block arrived this hop
        bias_hop = bias_rows[..., src * nl:(src + 1) * nl]
        bmap = block_map_from_keep(bias_hop >= 0.0, plan.block_q,
                                   plan.block_k)
        if bool((bmap == SKIP).all()):  # one device read a hop
            elided += 1
        else:
            _, state = sparse_attention(
                q, k_cur, v_cur, bias=bias_hop, block_map=bmap,
                block_q=plan.block_q, block_k=plan.block_k, carry=state,
                return_state=True)
        if h < shards - 1:
            # The rotation is never skipped: the next shards still need
            # the blocks, so elision saves compute, not communication.
            k_cur = _ppermute(k_cur, shards, +1)
            v_cur = _ppermute(v_cur, shards, +1)
    _, l, acc = state
    return finalize(acc, l, q.dtype), elided


# ---------------------------------------------------------------------------
# Pipelines (inside the dispatcher's shard_map, SEQ_AXIS bound)
# ---------------------------------------------------------------------------


def _snap_pipeline(q, k, v, thetas, scale, *, plan, grid, cfg, step,
                   cached, want_cache, total_steps):
    from repro_torch.core import decision_cache as dc

    geom = _geometry(grid, cfg, plan.seq_shards)
    t_valid = _t_valid(geom, grid, q.device)
    # The halo exchange runs whatever the refresh verdict: a collective
    # never depends on one shard's choice (§13/§14).
    q_slab, q_o0 = _halo_slab(q, geom, plan.seq_shards) \
        if cfg.snap_q else (None, 0)
    k_slab, k_o0 = _halo_slab(k, geom, plan.seq_shards) \
        if cfg.snap_k else (None, 0)

    def decide():
        q_src = (None if q_slab is None else
                 _decide_src(q_slab, geom, grid, thetas, cfg, q_o0, t_valid))
        k_src = (None if k_slab is None else
                 _decide_src(k_slab, geom, grid, thetas, cfg, k_o0, t_valid))
        return q_src, k_src

    if not want_cache:
        q_src, k_src = decide()
        q_s = q if q_src is None else _gather_src(q_slab, q_src)
        k_s = k if k_src is None else _gather_src(k_slab, k_src)
        return _reference_ring_execute(q_s, k_s, v, scale)

    stat = _drift(q, k, cfg)
    if cached is None or _refresh(step, cfg, stat, cached, total_steps):
        q_src, k_src = decide()
        hits, refreshes = _counters(cached, stat)
        cache = CachedDecision(q_idx=q_src, k_idx=k_src, ref_stat=_pack(stat),
                               hits=hits, refreshes=refreshes)
    else:
        cache = dc.bump_hit(cached)
    # The snap itself happens once, after the choice: both ways agree on
    # the source map, and replaying it is the same gather, which is why a
    # cache hit is bit for bit.
    q_s = q if cache.q_idx is None else _gather_src(q_slab, cache.q_idx)
    k_s = k if cache.k_idx is None else _gather_src(k_slab, cache.k_idx)
    return _reference_ring_execute(q_s, k_s, v, scale), cache


def _mask_pipeline(q, k, v, scale, *, plan, grid, cfg, step, cached,
                   want_cache, total_steps, policy=None):
    nl = q.shape[-2]
    off = spmd.axis_index(SEQ_AXIS) * nl
    plan_once = getattr(policy, "plan_once", False)
    hook = getattr(policy, "ring_bias_rows", None)
    if hook is not None:
        # Constant-mask policies render their own shard-local rows:
        # position-determined, no collectives; all-SKIP hops fall out of
        # the constant map.
        def bias_rows():
            return hook(q, k, grid=grid, cfg=cfg, row_offset=off,
                        n_rows=nl)
    else:
        # Sharded online head classification (svg) — a collective, so it
        # runs every step whatever the refresh verdict.
        is_spatial = classify_heads_sharded(q, k, grid, SEQ_AXIS)

        def bias_rows():
            keep = svg_keep_rows(is_spatial, grid, off, nl)
            return torch.where(keep, torch.zeros((), device=q.device),
                               torch.full((), float("-inf"),
                                          device=q.device))

    if not want_cache:
        out, _ = _sparse_ring_execute(q, k, v, bias_rows(), plan,
                                      plan.seq_shards)
        return out

    from repro_torch.core import decision_cache as dc

    stat = torch.zeros(q.shape[:-2], dtype=torch.float32, device=q.device) \
        if plan_once else _drift(q, k, cfg)
    if cached is None:
        refresh = True
    elif plan_once:
        # A refresh cadence of never (DESIGN.md §16): the step-0 constant
        # rows serve the whole trajectory.
        refresh = int(step) == 0
    else:
        refresh = _refresh(step, cfg, stat, cached, total_steps)
    if refresh:
        hits, refreshes = _counters(cached, stat)
        elided = (torch.zeros((1,), dtype=torch.int32, device=q.device)
                  if cached is None or cached.elided is None
                  else cached.elided)
        cache = CachedDecision(bias=bias_rows(), ref_stat=_pack(stat),
                               hits=hits, refreshes=refreshes, elided=elided)
    else:
        cache = dc.bump_hit(cached)
    out, elided = _sparse_ring_execute(q, k, v, cache.bias, plan,
                                       plan.seq_shards)
    cache = dataclasses.replace(cache, elided=cache.elided + elided)
    return out, cache


def ring_pipeline(q, k, v, thetas, scale, *, plan, grid,
                  cfg: RippleConfig, policy, step=None, cached=None,
                  want_cache: bool = False, total_steps=None):
    """One context-parallel attention call on this shard's (B, H,
    N_local, d) token slice.  Runs inside ``spmd.shard_map`` with
    ``SEQ_AXIS`` bound.  Returns ``out`` or ``(out, CachedDecision)``."""
    if plan.backend == "sparse":
        return _mask_pipeline(q, k, v, scale, plan=plan, grid=grid,
                              cfg=cfg, step=step, cached=cached,
                              want_cache=want_cache,
                              total_steps=total_steps, policy=policy)
    return _snap_pipeline(q, k, v, thetas, scale, plan=plan, grid=grid,
                          cfg=cfg, step=step, cached=cached,
                          want_cache=want_cache, total_steps=total_steps)


def ring_cache_specs(plan, cfg: RippleConfig) -> CachedDecision:
    """Partition specs of the ring cache's leaves, with exactly the None
    pattern :func:`ring_pipeline` produces, defined beside it so the two
    cannot drift.  Token-shaped leaves shard seq at dim 2; the packed
    per-shard stats and counters at their last dim; the elided counter
    is one int32 a shard."""
    b = (plan.batch_axes if len(plan.batch_axes) > 1
         else plan.batch_axes[0]) if plan.batch_axes else None
    h = plan.head_axis
    tok = P(b, h, SEQ_AXIS, None)
    stat = P(b, h, SEQ_AXIS)
    if plan.backend == "sparse":
        return CachedDecision(bias=tok, ref_stat=stat, hits=stat,
                              refreshes=stat, elided=P(SEQ_AXIS))
    return CachedDecision(q_idx=tok if cfg.snap_q else None,
                          k_idx=tok if cfg.snap_k else None,
                          ref_stat=stat, hits=stat, refreshes=stat)

"""Unified attention dispatch — the single seam every attention-bearing
model targets (DESIGN.md §8).

``attention_dispatch(q, k, v, grid=..., cfg=..., ...)`` owns, in order:

  1. **Policy resolution** — which registered
     :class:`~repro_torch.core.policy.ReusePolicy` decides the snaps.
  2. **Backend selection** — from ``cfg.backend`` / the ``backend``
     argument, the operands' device, the policy's needs and the shape.
     The names are the JAX package's, so a config means the same in both:
     ``dense`` (plain attention, no reuse), ``reference`` (dense attention
     on the snapped operands), ``collapse`` (the exact pair-collapse
     identities in plain PyTorch, ``core/collapse.py``), ``pallas``,
     which in the port names the hand-written CUDA ripple kernel
     (``kernels/ripple``), and ``sparse``, the hand-written CUDA
     block-sparse kernel (``kernels/sparse``) for policies that tile
     their masks into a skip/full/partial block map.  ``auto`` picks
     ``sparse`` for such policies on any device (the plain version on
     the CPU), as the reference does, and otherwise ``pallas`` for CUDA
     operands where the reference picks it on TPU, at any head dim: the
     kernel takes every head dim a config of the repo serves (up to 256)
     and raises on a larger one.
  3. **Mask pipeline placement** — the Δ-checks run in the fused CUDA
     kernel (``kernels/reuse_mask``) or on the host path
     (``core.reuse``), per ``cfg.fused_mask``; ``auto`` fuses on CUDA.
  4. **A small plan cache** keyed on power-of-two shape buckets.
  5. **The cross-step decision cache** (``core.decision_cache``): with a
     ``cached_decision`` or ``return_decision``, the policy decides anew
     only on refresh steps and otherwise re-applies the carried plan to
     the fresh operands (:func:`_run_pipeline_cached`); with
     ``cfg.sentinel`` the guardrail sentinels ride that state
     (``core.guardrail.attach_sentinel``).
  6. **Fault injection** (``serving.faults``): an armed ``attn_nan`` fault
     flips a non-dense backend's output to NaN (:func:`_inject_attn_nan`).

The plan cache is shared by every engine thread of a process (router
replicas on one card) and guarded by a lock.

When a mesh is active (:func:`dispatch_mesh` / :func:`set_dispatch_mesh`;
the launcher's ``--mesh`` installs one), plan resolution also records
**batch/head sharding**: the leading batch dim shards over the (pod,
data) axes and the heads dim over ``model`` whenever they divide, and
the whole pipeline — the Δ-checks included — runs once per shard under
``distributed.spmd.shard_map``, each shard in a thread of its own on its
own device and stream, while the model around it runs once on the first
device.  The reuse windows run along t/x/y, never along batch or heads,
so the halo of the sharded axes is zero and each shard's result is bit
for bit the single-device one (DESIGN.md §10).  Indivisible shapes
replicate.  A mesh with a third ``seq`` axis also shards the **token
axis**: context-parallel ring attention (``core.ring``, DESIGN.md §14)
for policies that declare ``will_seq_shard``, on shapes whose grid covers
the whole sequence with T divisible by the seq degree; anything else
replicates the token axis, and the plan line says which was chosen.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import RippleConfig
from repro_torch.core.collapse import collapsed_attention
from repro_torch.core.policy import (ReuseDecision, ReusePolicy, get_policy,
                                     list_policies, register_policy)
from repro_torch.distributed import sharding
from repro_torch.distributed.spmd import P
from repro_torch.kernels import on_card
from repro_torch.kernels.ripple.ops import TILE_PAIRS, attention_scale

__all__ = [
    "active_dispatch_mesh", "attention_dispatch", "DispatchPlan",
    "ReuseDecision", "ReusePolicy", "dense_attention", "dispatch_mesh",
    "get_policy", "list_policies", "register_policy", "resolve_backend",
    "resolve_plan", "set_dispatch_mesh", "shape_bucket", "time_best",
]

BACKENDS = ("auto", "dense", "reference", "collapse", "pallas", "sparse")
# The sparse kernel's (block_q, block_k) map tile.
_SPARSE_BLOCKS = (128, 128)
_PLAN_CACHE: "OrderedDict[Tuple, DispatchPlan]" = OrderedDict()
_PLAN_CACHE_CAP = 256
_PLAN_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Resolved execution plan for one (policy, shape-bucket, backend)
    cell.  ``block_q`` / ``block_k`` are the ripple kernel's tile (pairs)
    or the sparse kernel's map tile (tokens)."""

    backend: str
    policy: str = "ripple"
    block_q: int = TILE_PAIRS
    block_k: int = TILE_PAIRS
    fused_mask: bool = False
    bucket: Tuple[int, ...] = ()
    # Mesh sharding (DESIGN.md §10): the mesh axes that shard the leading
    # batch dim / the heads dim; () / None is replicated execution.
    batch_axes: Tuple[str, ...] = ()
    head_axis: Optional[str] = None
    batch_shards: int = 1
    head_shards: int = 1
    # Context-parallel ring attention (DESIGN.md §14): the mesh axis that
    # shards the token axis, None when the tokens stay replicated.
    seq_axis: Optional[str] = None
    seq_shards: int = 1

    @property
    def sharded(self) -> bool:
        return self.batch_shards * self.head_shards * self.seq_shards > 1

    def summary(self) -> str:
        blk = (f" block={self.block_q}x{self.block_k}"
               if self.backend in ("pallas", "sparse") else "")
        mask = " fused-mask" if self.fused_mask else ""
        shard = (f" shard=batch{self.batch_shards}x"
                 f"heads{self.head_shards}" if self.sharded else "")
        ring = f" ring=seq{self.seq_shards}" if self.seq_axis else ""
        return (f"attention[{self.policy}/{self.backend}{blk}{mask}{shard}"
                f"{ring} bucket={self.bucket}]")


def dense_attention(q, k, v, scale: float, bias=None):
    """Plain attention: the 'dense' backend and the inactive-config path.
    Logits come out of the product in the operands' dtype and are scaled
    in float32, as in the JAX package."""
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in ``out`` (a tensor, or a nest of
    tuples and lists of them)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, (tuple, list)):
        return set().union(*(_cuda_devices(o) for o in out))
    return set()


def time_best(fn, repeats: int = 3) -> float:
    """Warm once, then the best wall time of ``repeats`` calls, in
    seconds — the one timing idiom of the kernel benchmarks.  When
    ``fn`` returns CUDA tensors, their devices are synchronised before
    and after each timed call, so the time is the device's and not the
    enqueue's."""
    devices = _cuda_devices(fn())

    def sync():
        for dev in devices:
            torch.cuda.synchronize(dev)

    best = float("inf")
    for _ in range(max(repeats, 1)):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def shape_bucket(n: int) -> int:
    """Round up to the next power of two (min 64) — plan-cache bucket."""
    return max(64, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


# ---------------------------------------------------------------------------
# The active mesh (installed by the launcher; read by plan resolution)
# ---------------------------------------------------------------------------

_ACTIVE_MESH = None


def set_dispatch_mesh(mesh):
    """Install ``mesh`` (a ``launch.mesh.Mesh``) as the dispatch mesh;
    returns the previous one.  None restores single-device execution."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    return prev


def active_dispatch_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def dispatch_mesh(mesh):
    """Scoped :func:`set_dispatch_mesh` (tests, benchmarks)."""
    prev = set_dispatch_mesh(mesh)
    try:
        yield mesh
    finally:
        set_dispatch_mesh(prev)


def _mesh_key(mesh) -> Optional[Tuple]:
    if mesh is None:
        return None
    return tuple((a, int(mesh.shape[a])) for a in mesh.axis_names)


def _resolve_sharding(mesh, q_shape) -> Tuple:
    """(batch_axes, head_axis, batch_shards, head_shards) for q_shape: a
    greedy prefix of the (pod, data) axes that divides the leading batch
    dim; heads (dim 1 of a 4-D operand) over ``model`` when they divide.
    Anything indivisible stays replicated — never an error."""
    if mesh is None or len(q_shape) < 3:
        return (), None, 1, 1
    b_axes = []
    b_shards = 1
    B = q_shape[0]
    for a in sharding.batch_axes(mesh):
        n = sharding.axis_size(mesh, a)
        if n > 1 and B % (b_shards * n) == 0:
            b_axes.append(a)
            b_shards *= n
    head_axis, h_shards = None, 1
    if len(q_shape) >= 4 and "model" in mesh.axis_names:
        n = sharding.axis_size(mesh, "model")
        if n > 1 and q_shape[1] % n == 0:
            head_axis, h_shards = "model", n
    return tuple(b_axes), head_axis, b_shards, h_shards


def _resolve_seq_sharding(mesh, q_shape, resolved: str, cfg: RippleConfig,
                          pol: ReusePolicy, grid, grid_slice
                          ) -> Tuple[Optional[str], int]:
    """(seq_axis, seq_shards): is the context-parallel ring eligible
    (DESIGN.md §14)?  It needs a ``seq`` axis above 1, a ring-capable
    backend (reference or sparse), 4-D operands, a grid covering the
    whole sequence (no text prefix: ``grid_slice`` None after the
    full-range normalisation), a policy that declares ``will_seq_shard``
    and T divisible by the seq degree.  Anything else replicates the
    token axis — the reference's fallback, never an error."""
    if (mesh is None or "seq" not in mesh.axis_names or grid is None
            or grid_slice is not None or len(q_shape) < 4
            or resolved not in ("reference", "sparse")
            or not pol.will_seq_shard(cfg)):
        return None, 1
    s = sharding.axis_size(mesh, "seq")
    T = int(grid[0])
    n = math.prod(int(g) for g in grid)
    if s <= 1 or n != q_shape[-2] or T % s != 0:
        return None, 1
    return "seq", s


def resolve_backend(cfg: RippleConfig, backend: Optional[str], *,
                    has_bias: bool, n_tokens: int, on_cuda: bool,
                    policy: Optional[ReusePolicy] = None) -> str:
    """Collapse 'auto' onto a concrete backend for this call."""
    pol = policy if policy is not None else get_policy(cfg.policy)
    b = backend or cfg.backend or "auto"
    if b not in BACKENDS:
        raise ValueError(f"unknown backend {b!r}; expected one of {BACKENDS}")
    if not cfg.active() or pol.is_dense:
        return "dense"
    emits_bias = pol.will_emit_bias(cfg)
    # The sparse backend realizes a policy's mask as skipped tiles only
    # when the policy's own bias is the whole story: its FULL tiles never
    # read the bias, so an external caller bias would be dropped there.
    sparse_ok = pol.will_emit_block_map(cfg) and not has_bias
    if b != "auto":
        if emits_bias and b in ("pallas", "collapse"):
            return "sparse" if sparse_ok else "reference"
        if b == "sparse" and has_bias and pol.will_emit_block_map(cfg):
            return "reference"
        return b
    if sparse_ok:
        return "sparse"
    if (on_cuda and not has_bias and not emits_bias and cfg.window == 2
            and n_tokens % 2 == 0):
        return "pallas"
    if not pol.snaps_operands or emits_bias:
        return "reference"
    return "collapse" if cfg.execution == "collapse" else "reference"


def _fused_requested(cfg: RippleConfig, on_cuda: bool) -> bool:
    if cfg.fused_mask == "on":
        return True
    if cfg.fused_mask == "off":
        return False
    return on_cuda


def resolve_plan(q_shape, v_shape, cfg: RippleConfig, *, on_cuda: bool,
                 backend: Optional[str] = None, has_bias: bool = False,
                 policy=None, mesh=None, grid=None,
                 grid_slice=None) -> DispatchPlan:
    """Shape-bucketed, cached plan resolution.

    ``mesh`` defaults to the active dispatch mesh; with one, the key also
    holds the exact leading dims (sharding eligibility is a divisibility
    property, not a bucket property), the mesh shape, the grid and
    whether there is a grid slice, as the reference's does.  ``grid`` /
    ``grid_slice`` feed ring eligibility: a caller that knows only
    shapes never gets a ring plan."""
    if mesh is None:
        mesh = _ACTIVE_MESH
    if grid_slice is not None and tuple(grid_slice) == (0, q_shape[-2]):
        grid_slice = None  # a full-range slice is no slice at all
    pol = get_policy(policy if policy is not None else cfg.policy)
    *lead, n, d = q_shape
    resolved = resolve_backend(cfg, backend, has_bias=has_bias, n_tokens=n,
                               on_cuda=on_cuda, policy=pol)
    bh = math.prod(lead) if lead else 1
    # The reference's key, then the device kind.  The policy's plan token
    # (a pattern artifact's version) is in it only to match the
    # reference's: no field of a DispatchPlan comes from the artifact.
    key = (resolved, shape_bucket(bh), shape_bucket(n), d, v_shape[-1],
           pol.name, cfg.fused_mask, cfg.window, cfg.granularity,
           pol.plan_token(cfg))
    if mesh is not None:
        key = key + (_mesh_key(mesh), tuple(q_shape[:-2]), grid,
                     grid_slice is None)
    key = key + (on_cuda,)
    with _PLAN_LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            _PLAN_CACHE.move_to_end(key)
            return plan
        blocks = (_SPARSE_BLOCKS if resolved == "sparse"
                  else (TILE_PAIRS,) * 2)
        b_axes, h_axis, b_shards, h_shards = (
            _resolve_sharding(mesh, q_shape) if resolved != "dense"
            else ((), None, 1, 1))
        seq_axis, seq_shards = _resolve_seq_sharding(
            mesh, q_shape, resolved, cfg, pol, grid, grid_slice)
        plan = DispatchPlan(backend=resolved, policy=pol.name,
                            block_q=blocks[0], block_k=blocks[1],
                            fused_mask=_fused_requested(cfg, on_cuda),
                            bucket=key[1:3], batch_axes=b_axes,
                            head_axis=h_axis, batch_shards=b_shards,
                            head_shards=h_shards, seq_axis=seq_axis,
                            seq_shards=seq_shards)
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_CAP:
            _PLAN_CACHE.popitem(last=False)
        return plan


def _decide_extra(plan: DispatchPlan, policy: ReusePolicy,
                  cfg: RippleConfig) -> dict:
    """Only sparse plans for map-emitting policies pass ``block_shape``;
    a mapless decision under a forced 'sparse' runs all tiles."""
    if plan.backend == "sparse" and policy.will_emit_block_map(cfg):
        return {"block_shape": (plan.block_q, plan.block_k)}
    return {}


def _execute_backend(d: ReuseDecision, v, scale: float, *,
                     plan: DispatchPlan, cfg: RippleConfig):
    """Fig. 6 steps ③-④: run the planned backend on one decision."""
    if plan.backend == "pallas":
        from repro_torch.kernels.ripple.ops import ripple_attention

        return ripple_attention(d.q, d.k, v, bias=d.bias, window=cfg.window,
                                scale=scale)
    if plan.backend == "sparse":
        # The kernel takes its scale from the head dim, as the JAX wrapper.
        from repro_torch.kernels.sparse.ops import sparse_attention

        return sparse_attention(d.q, d.k, v, bias=d.bias,
                                block_map=d.block_map, block_q=plan.block_q,
                                block_k=plan.block_k)
    if plan.backend == "collapse":
        return collapsed_attention(d.q, d.k, v, bias=d.bias,
                                   window=cfg.window, scale=scale)
    return dense_attention(d.q, d.k, v, scale, d.bias)


def _inject_attn_nan(out: torch.Tensor, step, count: bool = True
                     ) -> torch.Tensor:
    """The ``attn_nan`` fault (``serving.faults``): with the fault armed,
    this call's output becomes NaN at the spec's denoising step.  Only
    the non-dense pipelines call this, so the ladder's dense rung clears
    the fault as it would clear a sparse-kernel bug.  Each flipped call
    counts one ``fault_attn_nan`` (``count``: a sharded call's shards
    flip their pieces, its first shard counts)."""
    if step is None:
        return out
    from repro_torch.serving import faults as fault_lib

    fault = fault_lib.active_faults()
    spec = fault.spec("attn_nan") if fault is not None else None
    if spec is None or int(step) != int(spec.param("step", 0)):
        return out
    if count:
        fault.note_fired("attn_nan")
    return torch.full_like(out, float("nan"))


def _run_pipeline(q, k, v, thetas, scale: float, bias, *,
                  plan: DispatchPlan, grid, cfg: RippleConfig, grid_slice,
                  policy: ReusePolicy):
    """Fig. 6 steps ①-④ for one resolved plan: the policy's decision,
    then the planned backend on it.  Shard-oblivious: it runs the same on
    the whole operands or on one batch/head shard (decisions look only
    along t/x/y, DESIGN.md §10)."""
    d = policy.decide(q, k, grid=grid, cfg=cfg, thetas=thetas, bias=bias,
                      grid_slice=grid_slice, fused=plan.fused_mask,
                      **_decide_extra(plan, policy, cfg))
    return _execute_backend(d, v, scale, plan=plan, cfg=cfg)


def _run_pipeline_cached(q, k, v, thetas, scale: float, *,
                         plan: DispatchPlan, grid, cfg: RippleConfig,
                         grid_slice, policy: ReusePolicy, step: int, cached,
                         total_steps: Optional[int] = None,
                         count_fault: bool = True):
    """The cross-step decision-cache pipeline (DESIGN.md §13): decide
    anew when the cadence or the drift guard says the cached plan is
    stale (or there is none yet), otherwise re-apply the carried plan to
    the fresh operands; then the backend runs once on the chosen
    decision.  Refresh or reuse is chosen on the host: the step and the
    cadence are Python ints, and only the drift guard reads the device
    (one bool a call, in ``refresh_due``).  With ``cfg.sentinel`` the
    output's readings are folded into the new state
    (``core.guardrail.attach_sentinel``; the probe compares against the
    original q and k, so it measures the whole approximation).  Returns
    (out, new_cache)."""
    from repro_torch.core import decision_cache as dc

    plan_once = getattr(policy, "plan_once", False)
    # The drift statistic is worth its pass only when the guard can act
    # on it; otherwise the cache keeps a zero stat of the same shape.
    if cfg.drift_tol > 0 and not plan_once:
        stat = dc.drift_stat(q, k, cfg)
    else:
        stat = torch.zeros(q.shape[:-2], dtype=torch.float32,
                           device=q.device)
    if cached is None:
        refresh = True
    elif plan_once:
        refresh = int(step) == 0
    else:
        refresh = dc.refresh_due(step, cfg, stat, cached.ref_stat,
                                 total_steps)
    if refresh:
        d = policy.decide(q, k, grid=grid, cfg=cfg, thetas=thetas,
                          bias=None, grid_slice=grid_slice,
                          fused=plan.fused_mask, want_plan=True,
                          **_decide_extra(plan, policy, cfg))
        new_cache = dc.cache_from_decision(d, stat, prev=cached)
    else:
        d = policy.apply_decision(q, k, cached, grid=grid, cfg=cfg,
                                  thetas=thetas, grid_slice=grid_slice,
                                  **_decide_extra(plan, policy, cfg))
        new_cache = dc.bump_hit(cached)
    out = _inject_attn_nan(_execute_backend(d, v, scale, plan=plan, cfg=cfg),
                           step, count_fault)
    if cfg.sentinel:
        from repro_torch.core import guardrail

        new_cache = guardrail.attach_sentinel(new_cache, out, q, k, v, scale,
                                              step, cfg)
    return out, new_cache


def _operand_spec(plan: DispatchPlan, ndim: int) -> P:
    """Partition spec of a (..., N, d) attention operand under ``plan``."""
    entries: list = [None] * ndim
    if plan.batch_axes:
        entries[0] = (plan.batch_axes if len(plan.batch_axes) > 1
                      else plan.batch_axes[0])
    if plan.head_axis is not None and ndim >= 4:
        entries[1] = plan.head_axis
    if plan.seq_axis is not None and ndim >= 3:
        entries[ndim - 2] = plan.seq_axis
    return P(*entries)


def _lead_spec(plan: DispatchPlan, ndim: int) -> P:
    """Partition spec of a decision-cache leaf: every leaf keeps the
    operands' leading (batch, head) dims (DESIGN.md §13), whatever its
    trailing rank.  ``plan.head_axis`` is set for 4-D operands only, so
    dim 1 is always the heads here."""
    entries: list = [None] * ndim
    if plan.batch_axes and ndim >= 1:
        entries[0] = (plan.batch_axes if len(plan.batch_axes) > 1
                      else plan.batch_axes[0])
    if plan.head_axis is not None and ndim >= 2:
        entries[1] = plan.head_axis
    return P(*entries)


def _sharded_pipeline(q, k, v, thetas, scale: float, *, plan: DispatchPlan,
                      mesh, grid, cfg: RippleConfig, grid_slice,
                      policy: ReusePolicy, step=None, cached=None,
                      want_cache: bool = False, total_steps=None):
    """The pipeline once per shard of the plan's mesh axes
    (``spmd.shard_map``).  Batch/head shards run :func:`_run_pipeline` /
    :func:`_run_pipeline_cached` with no collective: the sharded axes
    carry no reuse window, so each shard's decision is self-contained
    and the result bit for bit the replicated one.  With ``want_cache``
    the decision cache rides along: every leaf keeps the operands'
    leading dims, so each shard carries and refreshes its own slice.  A
    ``seq`` axis runs ``core.ring`` instead.  Returns ``out`` or ``(out,
    new_cache)``."""
    from repro_torch.distributed.spmd import first_shard, shard_map

    spec = _operand_spec(plan, q.ndim)
    in_specs = (spec, spec, spec)
    if plan.seq_axis is not None:
        from repro_torch.core import ring as ring_lib

        if not want_cache:
            def ring_body(qs, ks, vs):
                return ring_lib.ring_pipeline(
                    qs, ks, vs, thetas, scale, plan=plan, grid=grid,
                    cfg=cfg, policy=policy)

            return shard_map(ring_body, mesh, in_specs, spec)(q, k, v)
        cache_specs = ring_lib.ring_cache_specs(plan, cfg)

        def ring_cached(qs, ks, vs, cache=None):
            return ring_lib.ring_pipeline(
                qs, ks, vs, thetas, scale, plan=plan, grid=grid, cfg=cfg,
                policy=policy, step=step, cached=cache, want_cache=True,
                total_steps=total_steps)

        args = (q, k, v) + ((cached,) if cached is not None else ())
        specs = in_specs + ((cache_specs,) if cached is not None else ())
        return shard_map(ring_cached, mesh, specs,
                         (spec, cache_specs))(*args)

    if not want_cache:
        def body(qs, ks, vs):
            return _run_pipeline(qs, ks, vs, thetas, scale, None, plan=plan,
                                 grid=grid, cfg=cfg, grid_slice=grid_slice,
                                 policy=policy)

        return shard_map(body, mesh, in_specs, spec)(q, k, v)

    def lead(leaf):
        return _lead_spec(plan, leaf.ndim)

    def body_cached(qs, ks, vs, cache=None):
        return _run_pipeline_cached(
            qs, ks, vs, thetas, scale, plan=plan, grid=grid, cfg=cfg,
            grid_slice=grid_slice, policy=policy, step=step, cached=cache,
            total_steps=total_steps, count_fault=first_shard())

    args = (q, k, v) + ((cached,) if cached is not None else ())
    specs = in_specs + ((lead,) if cached is not None else ())
    return shard_map(body_cached, mesh, specs, (spec, lead))(*args)


def attention_dispatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       grid: Tuple[int, int, int], cfg: RippleConfig,
                       step: Optional[int] = None,
                       total_steps: Optional[int] = None,
                       thetas: Optional[Dict[str, float]] = None,
                       bias: Optional[torch.Tensor] = None,
                       grid_slice: Optional[Tuple[int, int]] = None,
                       backend: Optional[str] = None,
                       policy=None, cached_decision=None,
                       return_decision: bool = False, mesh=None):
    """Attention with TimeRipple reuse behind one dispatch seam.

    q, k, v: (..., N, head_dim), post-RoPE.  ``policy`` overrides
    ``cfg.policy``; ``backend`` overrides ``cfg.backend`` ('dense'
    bypasses the reuse pipeline); ``thetas`` overrides the policy's
    per-step schedule (otherwise derived from ``step``/``total_steps``);
    ``grid_slice = (start, n)`` marks the grid tokens of a text+grid
    sequence.

    Cross-step decision cache (DESIGN.md §13): ``cached_decision`` is a
    :class:`~repro_torch.core.decision_cache.CachedDecision` from an
    earlier call on operands of the same shapes; the decision is then
    made anew only on refresh steps and re-applied to the fresh operands
    otherwise.  ``return_decision=True`` (implied by a
    ``cached_decision``) returns ``(out, new CachedDecision)``.  Caching
    needs an active cache-capable policy, a concrete ``step`` and no
    external ``bias``.

    ``mesh`` overrides the active dispatch mesh; when the resolved plan
    shards, the pipeline runs once per shard (:func:`_sharded_pipeline`,
    DESIGN.md §10, §14) and the output is gathered onto q's device.
    """
    if mesh is None:
        mesh = _ACTIVE_MESH
    if grid_slice is not None and tuple(grid_slice) == (0, q.shape[-2]):
        grid_slice = None
    pol = get_policy(policy if policy is not None else cfg.policy)
    scale = attention_scale(q.shape[-1])
    plan = resolve_plan(q.shape, v.shape, cfg, on_cuda=on_card(q),
                        backend=backend, has_bias=bias is not None,
                        policy=pol, mesh=mesh, grid=grid,
                        grid_slice=grid_slice)
    want_cache = return_decision or cached_decision is not None
    if want_cache:
        if plan.backend == "dense" or not pol.will_cache_decisions(cfg):
            raise ValueError(
                f"decision caching requested but policy {pol.name!r} "
                f"under this config resolves to {plan.backend!r}/"
                f"caches_decisions={pol.will_cache_decisions(cfg)} — gate "
                f"on decision_cache.supports_cache(cfg, policy) first")
        if bias is not None:
            raise ValueError("decision caching requires bias=None (the "
                             "cached plan could not account for a fresh "
                             "external bias)")
        if step is None:
            raise ValueError("decision caching needs a concrete step for "
                             "the reuse_every cadence")
    if plan.backend == "dense":
        return dense_attention(q, k, v, scale, bias)
    thetas = pol.thetas_for(cfg, step, total_steps, thetas)
    # An external bias would need a spec of its own: it stays replicated.
    if mesh is not None and plan.sharded and bias is None:
        res = _sharded_pipeline(q, k, v, thetas, scale, plan=plan,
                                mesh=mesh, grid=grid, cfg=cfg,
                                grid_slice=grid_slice, policy=pol,
                                step=step, cached=cached_decision,
                                want_cache=want_cache,
                                total_steps=total_steps)
        # The cached body injects faults inside its shards; the plain
        # sharded path returns the bare output, so inject here.
        return res if want_cache else _inject_attn_nan(res, step)
    if want_cache:
        return _run_pipeline_cached(
            q, k, v, thetas, scale, plan=plan, grid=grid, cfg=cfg,
            grid_slice=grid_slice, policy=pol, step=step,
            cached=cached_decision, total_steps=total_steps)
    return _inject_attn_nan(_run_pipeline(
        q, k, v, thetas, scale, bias, plan=plan, grid=grid, cfg=cfg,
        grid_slice=grid_slice, policy=pol), step)

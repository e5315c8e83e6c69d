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
     operands where the reference picks it on TPU.
  3. **Mask pipeline placement** — the Δ-checks run in the fused CUDA
     kernel (``kernels/reuse_mask``) or on the host path
     (``core.reuse``), per ``cfg.fused_mask``; ``auto`` fuses on CUDA.
  4. **A small plan cache** keyed on power-of-two shape buckets.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import RippleConfig
from repro_torch.core.collapse import collapsed_attention
from repro_torch.core.policy import (ReuseDecision, ReusePolicy, get_policy,
                                     list_policies, register_policy)
from repro_torch.kernels.ripple.ops import TILE_PAIRS, attention_scale

__all__ = [
    "attention_dispatch", "DispatchPlan", "ReuseDecision", "ReusePolicy",
    "dense_attention", "get_policy", "list_policies", "register_policy",
    "resolve_backend", "resolve_plan", "shape_bucket", "time_best",
]

BACKENDS = ("auto", "dense", "reference", "collapse", "pallas", "sparse")
# The sparse kernel's (block_q, block_k) map tile.
_SPARSE_BLOCKS = (128, 128)
_PLAN_CACHE: "OrderedDict[Tuple, DispatchPlan]" = OrderedDict()
_PLAN_CACHE_CAP = 256


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

    def summary(self) -> str:
        blk = (f" block={self.block_q}x{self.block_k}"
               if self.backend in ("pallas", "sparse") else "")
        mask = " fused-mask" if self.fused_mask else ""
        return (f"attention[{self.policy}/{self.backend}{blk}{mask} "
                f"bucket={self.bucket}]")


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
                 policy=None) -> DispatchPlan:
    """Shape-bucketed, cached plan resolution."""
    pol = get_policy(policy if policy is not None else cfg.policy)
    *lead, n, d = q_shape
    resolved = resolve_backend(cfg, backend, has_bias=has_bias, n_tokens=n,
                               on_cuda=on_cuda, policy=pol)
    bh = math.prod(lead) if lead else 1
    key = (resolved, shape_bucket(bh), shape_bucket(n), d, v_shape[-1],
           pol.name, cfg.fused_mask, cfg.window, cfg.granularity, on_cuda)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE.move_to_end(key)
        return plan
    blocks = _SPARSE_BLOCKS if resolved == "sparse" else (TILE_PAIRS,) * 2
    plan = DispatchPlan(backend=resolved, policy=pol.name,
                        block_q=blocks[0], block_k=blocks[1],
                        fused_mask=_fused_requested(cfg, on_cuda),
                        bucket=key[1:3])
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


def attention_dispatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       grid: Tuple[int, int, int], cfg: RippleConfig,
                       step: Optional[int] = None,
                       total_steps: Optional[int] = None,
                       thetas: Optional[Dict[str, float]] = None,
                       bias: Optional[torch.Tensor] = None,
                       grid_slice: Optional[Tuple[int, int]] = None,
                       backend: Optional[str] = None,
                       policy=None) -> torch.Tensor:
    """Attention with TimeRipple reuse behind one dispatch seam.

    q, k, v: (..., N, head_dim), post-RoPE.  ``policy`` overrides
    ``cfg.policy``; ``backend`` overrides ``cfg.backend`` ('dense'
    bypasses the reuse pipeline); ``thetas`` overrides the policy's
    per-step schedule (otherwise derived from ``step``/``total_steps``);
    ``grid_slice = (start, n)`` marks the grid tokens of a text+grid
    sequence.
    """
    if grid_slice is not None and tuple(grid_slice) == (0, q.shape[-2]):
        grid_slice = None
    pol = get_policy(policy if policy is not None else cfg.policy)
    scale = attention_scale(q.shape[-1])
    plan = resolve_plan(q.shape, v.shape, cfg, on_cuda=q.is_cuda,
                        backend=backend, has_bias=bias is not None,
                        policy=pol)
    if plan.backend == "dense":
        return dense_attention(q, k, v, scale, bias)
    thetas = pol.thetas_for(cfg, step, total_steps, thetas)
    d = pol.decide(q, k, grid=grid, cfg=cfg, thetas=thetas, bias=bias,
                   grid_slice=grid_slice, fused=plan.fused_mask,
                   **_decide_extra(plan, pol, cfg))
    return _execute_backend(d, v, scale, plan=plan, cfg=cfg)

"""SVG-style structured attention masking (Sparse VideoGen, Xi et al. '25).

The baseline the paper combines with (TIMERIPPLE+SVG row of Tbl. 2).
SVG classifies each head online as *spatial* (tokens attend within their
own frame → frame-block-diagonal mask) or *temporal* (tokens attend to
the same spatial location across frames → strided-diagonal mask) by
measuring which mask retains more attention mass on a row sample, then
skips masked blocks.

The (N, N) masks depend on the grid only; they are built in numpy, as
the JAX package builds them, and kept on each device they were asked
for, so a serving run builds them once per (grid, device).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def spatial_mask(grid: Tuple[int, int, int]) -> np.ndarray:
    """Frame-block-diagonal mask: attend within the same frame (+sink frame)."""
    T, H, W = grid
    f = np.repeat(np.arange(T), H * W)
    mask = f[:, None] == f[None, :]
    mask |= f[None, :] == 0  # first-frame attention sink (per SVG)
    return mask


def temporal_mask(grid: Tuple[int, int, int], halo: int = 1) -> np.ndarray:
    """Strided-diagonal mask: same spatial site across frames (± halo)."""
    T, H, W = grid
    s = np.tile(np.arange(H * W), T)
    diff = np.abs(s[:, None] - s[None, :])
    return diff <= halo


def mask_density(mask: np.ndarray) -> float:
    return float(mask.mean())


@functools.lru_cache(maxsize=8)
def _device_masks(grid: Tuple[int, int, int], device: torch.device):
    """(spatial, temporal) bool masks of ``grid`` on ``device``."""
    return (torch.from_numpy(spatial_mask(grid)).to(device),
            torch.from_numpy(temporal_mask(grid)).to(device))


def classify_heads(q: torch.Tensor, k: torch.Tensor, grid,
                   sample_rows: int = 64, scale=None) -> torch.Tensor:
    """Per-head bool: True = spatial head, False = temporal head (a tie
    goes to spatial).

    Measures retained softmax mass of each candidate mask on a row
    subsample (SVG's online profiling step).  The product comes out in
    the operands' dtype; the scale and the softmax are float32, as the
    JAX package's float64 numpy scale promotes them.
    """
    *lead, N, d = q.shape
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    # float64 linspace truncated to int32, exactly as the JAX package
    # picks its profiling rows.
    rows = np.linspace(0, N - 1, min(sample_rows, N)).astype(np.int32)
    idx = torch.from_numpy(rows.astype(np.int64)).to(q.device)
    qs = q.index_select(-2, idx)
    logits = torch.matmul(qs, k.transpose(-1, -2)).float() * float(scale)
    probs = torch.softmax(logits, dim=-1)
    sp, tm = _device_masks(tuple(grid), q.device)
    sp, tm = sp.index_select(0, idx), tm.index_select(0, idx)
    zero = probs.new_zeros(())
    mass_sp = torch.where(sp, probs, zero).sum(dim=(-1, -2))
    mass_tm = torch.where(tm, probs, zero).sum(dim=(-1, -2))
    return mass_sp >= mass_tm


def classify_heads_sharded(q: torch.Tensor, k: torch.Tensor, grid,
                           axis_name: str, sample_rows: int = 64,
                           scale=None) -> torch.Tensor:
    """:func:`classify_heads` when the token axis is sharded over the
    mesh axis ``axis_name`` (the context-parallel ring, DESIGN.md §14).
    ``q`` / ``k`` are one shard's (..., N_loc, d) token slice; the sampled
    rows are assembled with ``psum`` and the softmax row statistics
    reduced with ``pmax`` / ``psum`` (``distributed.spmd``), so every
    shard returns the same per-head verdict, equal to the single-device
    one up to the cross-shard summation order.  Called from inside
    ``spmd.shard_map``, every step on the ring path (collectives never
    sit inside the decision cache's refresh choice)."""
    from repro_torch.distributed import spmd

    *lead, n_loc, d = q.shape
    T, H, W = grid
    n = T * H * W
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    off = spmd.axis_index(axis_name) * n_loc
    rows = np.linspace(0, n - 1, min(sample_rows, n)).astype(np.int32)
    r = torch.from_numpy(rows.astype(np.int64)).to(q.device)
    # Each shard contributes the sampled rows it owns; psum fills in the
    # rest.
    owned = (r >= off) & (r < off + n_loc)
    local = (r - off).clamp(0, n_loc - 1)
    qs = torch.where(owned[:, None], q.index_select(-2, local),
                     q.new_zeros(()))
    qs = spmd.psum(qs, axis_name)
    logits = torch.matmul(qs, k.transpose(-1, -2)).float() * float(scale)
    m = spmd.pmax(logits.amax(dim=-1), axis_name)
    p = torch.exp(logits - m[..., None])
    denom = spmd.psum(p.sum(dim=-1), axis_name)            # (..., R)
    sp, tm = _device_masks(tuple(grid), q.device)
    zero = p.new_zeros(())

    def mass(full_mask):
        cols = full_mask.index_select(0, r)[:, off:off + n_loc]
        num = spmd.psum(torch.where(cols, p, zero).sum(dim=-1), axis_name)
        return (num / denom).sum(dim=-1)

    return mass(sp) >= mass(tm)


def svg_keep_rows(is_spatial: torch.Tensor, grid, row_offset: int,
                  n_rows: int) -> torch.Tensor:
    """A shard's slice of the classified keep-mask: the ``n_rows`` query
    rows from ``row_offset``, against all N key columns — (..., n_rows,
    N) for per-head verdicts ``is_spatial``."""
    sp, tm = _device_masks(tuple(grid), is_spatial.device)
    sp_rows = sp[row_offset:row_offset + n_rows]
    tm_rows = tm[row_offset:row_offset + n_rows]
    return torch.where(is_spatial[..., None, None], sp_rows, tm_rows)


def _classified_mask(q: torch.Tensor, k: torch.Tensor, grid):
    """(keep-mask (..., N, N), per-head verdicts (...)) of the SVG choice."""
    is_spatial = classify_heads(q, k, grid)
    sp, tm = _device_masks(tuple(grid), q.device)
    return torch.where(is_spatial[..., None, None], sp, tm), is_spatial


def svg_block_mask(q: torch.Tensor, k: torch.Tensor, grid) -> torch.Tensor:
    """Boolean keep-mask (..., N, N) per head, SVG spatial/temporal choice."""
    return _classified_mask(q, k, grid)[0]


@functools.lru_cache(maxsize=8)
def _kept_entries(grid: Tuple[int, int, int]) -> Tuple[int, int]:
    """Kept entries of the spatial and of the temporal mask of ``grid``."""
    return int(spatial_mask(grid).sum()), int(temporal_mask(grid).sum())


def svg_savings(is_spatial: torch.Tensor, grid, n_tokens: int,
                grid_slice=None) -> torch.Tensor:
    """1 - the keep density of the classified (..., N, N) mask: the JAX SVG
    policy's ``savings``.  Counted exactly from the per-head verdicts and
    each mask's kept entries (text rows and columns dense), so the
    (..., N, N) mask is never reduced; the count is rounded once to
    float32 and divided in float32, as the JAX package's mean divides its
    float32 sum."""
    n_sp, n_tm = _kept_entries(tuple(grid))
    n_grid = grid[0] * grid[1] * grid[2] if grid_slice is not None else n_tokens
    dense = n_tokens * n_tokens - n_grid * n_grid
    heads = is_spatial.numel()
    kept = is_spatial.sum() * (n_sp - n_tm) + heads * (dense + n_tm)
    total = torch.full((), float(heads * n_tokens * n_tokens),
                       dtype=torch.float32, device=is_spatial.device)
    return 1.0 - kept.to(torch.float32) / total


def svg_logit_bias(q: torch.Tensor, k: torch.Tensor, grid,
                   grid_slice=None, bias=None, *, with_savings=False):
    """Keep-mask + additive −inf logit bias for the classified block mask.

    ``grid_slice=(start, n)`` restricts classification and masking to the
    grid tokens of a mixed text+grid sequence — text rows/columns stay
    dense.  Returns ``(keep, bias)`` where ``bias`` folds any caller-
    provided bias in.  Both are dense (..., N, N) tensors, the JAX
    package's contract.  ``with_savings`` appends :func:`svg_savings`.
    """
    N = q.shape[-2]
    if grid_slice is None:
        keep, is_spatial = _classified_mask(q, k, grid)
    else:
        s, n = grid_slice
        keep_seg, is_spatial = _classified_mask(
            q.narrow(-2, s, n), k.narrow(-2, s, n), grid)
        keep = torch.ones(q.shape[:-2] + (N, N), dtype=torch.bool,
                          device=q.device)
        keep[..., s:s + n, s:s + n] = keep_seg
    svg = torch.where(keep, torch.zeros((), device=q.device),
                      torch.full((), float("-inf"), device=q.device))
    out = (keep, svg if bias is None else bias + svg)
    if with_savings:
        out += (svg_savings(is_spatial, grid, N, grid_slice),)
    return out

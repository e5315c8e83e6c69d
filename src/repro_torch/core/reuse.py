"""TimeRipple reuse: windowed Δ similarity checks + operand snapping.

Paper §3.3 steps ①-②.  For both Q and K, tokens on the (T, H, W) latent
grid undergo a similarity check along each of the temporal / x / y axes.
The similarity of a window ``a`` of ``K`` tokens at one channel is the
standard error (Eq. 3)::

    Δ(a) = sqrt( Σ_i (a_i − ā)² / K )

Windows partition each axis.  Where Δ is below the axis threshold, the
non-representative window elements are *snapped* to the representative
(the first element of the window).  Because attention logits are
bilinear, snapping the operand is exactly equivalent to reusing the
partial attention scores (DESIGN.md §2).

Token order convention: row-major ``(t, y, x)`` — ``index = (t*H + y)*W + x``.

Rounding contract: every mean is a float32 sum times the float32
reciprocal of its count, rounded once to the operand's dtype, and every other op rounds to the
operand's dtype, as the JAX package's host path does; the channel mean
of the ``token`` and ``group`` gates sums channels in ascending order.
The fused CUDA kernel (``kernels/reuse_mask``) repeats exactly this
sequence, so the two agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("t", "x", "y")
# Grid dims are (..., T, H, W, d): axis name -> which dim the window runs
# on (negative, counted from the channel dim at -1).
_AXIS_DIM = {"t": -4, "y": -3, "x": -2}


@dataclasses.dataclass
class ReuseResult:
    """Output of :func:`compute_reuse`.

    snapped:    x with reusable entries overwritten by their representative.
    mask:       bool, same shape as x; True where the value was snapped.
    axis_masks: per-axis bool masks (before priority resolution).
    src_idx:    int32 snap-source token map, same shape as x (only with
                ``want_src``): each entry's source token, its own where
                it did not snap.
    """

    snapped: torch.Tensor
    mask: torch.Tensor
    axis_masks: Dict[str, torch.Tensor]
    src_idx: Optional[torch.Tensor] = None


def _inv(n: int) -> float:
    """float32 reciprocal of a count.  A mean multiplies by it, as XLA
    does after rewriting a division by a constant."""
    return float(np.float32(1.0) / np.float32(n))


def _window_mean(grouped: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean over a (small) window dim: float32 sum times the float32
    reciprocal of the count, one rounding."""
    n = grouped.shape[dim]
    return (grouped.float().sum(dim=dim) * _inv(n)).to(grouped.dtype)


def channel_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the channel dim (-1), keepdim: channels summed in float32
    in ascending order, times the float32 reciprocal of the count,
    rounded once to x's dtype."""
    acc = x[..., 0].float()
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c].float()
    return (acc * _inv(x.shape[-1])).to(x.dtype).unsqueeze(-1)


def window_delta(x: torch.Tensor, dim: int, window: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-window, per-channel Δ (Eq. 3) and the window representative.

    ``x`` has the window axis at ``dim`` (length L); the trailing axis is
    channels.  Returns ``(delta, rep)`` with the window axis reduced to
    ``L // window`` groups; remainder elements are excluded.
    """
    dim = dim % x.ndim
    L = x.shape[dim]
    n = L // window
    head = x.narrow(dim, 0, n * window)
    grouped = head.reshape(head.shape[:dim] + (n, window)
                           + head.shape[dim + 1:])
    mean = _window_mean(grouped, dim + 1).unsqueeze(dim + 1)
    delta = torch.sqrt(_window_mean(torch.square(grouped - mean), dim + 1))
    rep = grouped.select(dim + 1, 0)
    return delta, rep


def _expand_window(values: torch.Tensor, dim: int, window: int, length: int,
                   first_is_rep: bool) -> torch.Tensor:
    """Broadcast per-window values back to per-token positions; the
    window-first slot of a mask is forced False when ``first_is_rep``."""
    dim = dim % values.ndim
    n = values.shape[dim]
    expanded = torch.repeat_interleave(values, window, dim=dim)
    if first_is_rep:
        follower = torch.arange(n * window, device=values.device) % window != 0
        shape = [1] * expanded.ndim
        shape[dim] = n * window
        expanded = expanded & follower.reshape(shape)
    pad = length - n * window
    if pad > 0:
        pad_shape = list(expanded.shape)
        pad_shape[dim] = pad
        filler = torch.zeros(pad_shape, dtype=expanded.dtype,
                             device=expanded.device)
        expanded = torch.cat([expanded, filler], dim=dim)
    return expanded


def _group_bounds(head_dim: int, channel_groups: Sequence[float]
                  ) -> Dict[str, Tuple[int, int]]:
    """RoPE channel-group slices (t, x, y) from a fractional split."""
    ct = int(round(channel_groups[0] * head_dim))
    cx = int(round(channel_groups[1] * head_dim))
    ct = max(min(ct, head_dim), 0)
    cx = max(min(cx, head_dim - ct), 0)
    return {"t": (0, ct), "x": (ct, ct + cx), "y": (ct + cx, head_dim)}


def axis_reuse_mask(x_grid: torch.Tensor, axis: str, theta, window: int,
                    granularity: str = "channel",
                    channel_groups: Sequence[float] = (0.125, 0.4375, 0.4375)
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reuse mask and representative values along one grid axis.

    x_grid: (..., T, H, W, d).  Returns (mask, rep_values), both shaped
    like ``x_grid``; ``rep_values`` holds the representative's value at
    every position (identity at non-snappable positions).
    """
    dim = _AXIS_DIM[axis] % x_grid.ndim
    length = x_grid.shape[dim]
    if length < window:
        return torch.zeros(x_grid.shape, dtype=torch.bool,
                           device=x_grid.device), x_grid
    delta, rep = window_delta(x_grid, dim, window)
    theta = torch.as_tensor(theta, dtype=x_grid.dtype, device=x_grid.device)
    if granularity == "channel":
        ok = delta < theta
    elif granularity == "token":
        ok = (channel_mean(delta) < theta).expand(delta.shape)
    elif granularity == "group":
        bounds = _group_bounds(x_grid.shape[-1], channel_groups)
        parts = []
        for name in AXES:
            lo, hi = bounds[name]
            if hi <= lo:
                continue
            seg = delta[..., lo:hi]
            parts.append((channel_mean(seg) < theta).expand(seg.shape))
        ok = torch.cat(parts, dim=-1)
    else:
        raise ValueError(f"unknown granularity {granularity!r}")
    mask = _expand_window(ok, dim, window, length, first_is_rep=True)
    rep_full = _expand_window(rep, dim, window, length, first_is_rep=False)
    n = (length // window) * window
    if n < length:
        # Remainder positions: rep_full was zero-padded; use identity.
        keep = torch.arange(length, device=x_grid.device) < n
        shape = [1] * x_grid.ndim
        shape[dim] = length
        rep_full = torch.where(keep.reshape(shape), rep_full, x_grid)
    return mask, rep_full


def axis_source_tokens(grid: Tuple[int, int, int], axis: str, window: int,
                       device=None) -> torch.Tensor:
    """(N,) int32 map: each token's window-representative token index
    along ``axis`` (identity on the remainder tail that never snaps), in
    the module's row-major (t, y, x) token order."""
    T, H, W = grid
    t, y, x = torch.meshgrid(torch.arange(T, device=device),
                             torch.arange(H, device=device),
                             torch.arange(W, device=device), indexing="ij")
    coords = {"t": t, "y": y, "x": x}
    length = {"t": T, "y": H, "x": W}[axis]
    n = (length // window) * window
    c = coords[axis]
    coords[axis] = torch.where(c < n, (c // window) * window, c)
    flat = (coords["t"] * H + coords["y"]) * W + coords["x"]
    return flat.reshape(-1).to(torch.int32)


def compute_reuse(x: torch.Tensor, grid: Tuple[int, int, int],
                  thetas: Dict[str, float], axes: Sequence[str] = AXES,
                  window: int = 2, granularity: str = "channel",
                  channel_groups: Sequence[float] = (0.125, 0.4375, 0.4375),
                  protect_axis: Optional[str] = None,
                  want_src: bool = False,
                  t_valid: Optional[torch.Tensor] = None) -> ReuseResult:
    """Full TimeRipple reuse for one operand (Q or K).

    x: (..., N, d) with N == T*H*W tokens in (t, y, x) row-major order.
    thetas: per-axis thresholds {"t": θt, "x": θx, "y": θy}.
    Aggregation is a logical OR across axes (paper step ②); where several
    axes pass, the first axis in ``axes`` wins the copy source.  Every
    axis mask is computed from the *original* operand.

    ``protect_axis`` is the collapse-aware refinement (DESIGN.md §4):
    window *representatives* along that axis are never snapped by the
    other axes, so the value-identity of that axis's pairs survives high
    thresholds and the pair-collapse kernel keeps its tile skips.

    ``want_src`` also returns ``ReuseResult.src_idx``, the per-entry
    snap-source map the decision cache replays with one gather:
    ``torch.gather(x, -2, src_idx)`` equals ``snapped`` bit for bit (both
    copy the representative's entries).

    ``t_valid`` is a (T,) bool gating the temporal axis only: frames
    where it is False never t-snap (their x/y checks still apply).  The
    context-parallel ring (``core.ring``, DESIGN.md §14) uses it to
    disqualify windows that reach past the global frame count when
    reuse runs on a halo-extended shard-local slab.
    """
    T, H, W = grid
    *lead, N, d = x.shape
    if N != T * H * W:
        raise ValueError(f"token count {N} != grid {grid}")
    x_grid = x.reshape(*lead, T, H, W, d)
    protected = None
    if protect_axis is not None:
        dim = _AXIS_DIM[protect_axis] % x_grid.ndim
        length = x_grid.shape[dim]
        pos = torch.arange(length, device=x.device)
        is_rep = (pos % window == 0) & (pos < (length // window) * window)
        shape = [1] * x_grid.ndim
        shape[dim] = length
        protected = is_rep.reshape(shape)
    snapped = x_grid
    claimed = torch.zeros(x_grid.shape, dtype=torch.bool, device=x.device)
    axis_masks: Dict[str, torch.Tensor] = {}
    src = None
    if want_src:
        src = torch.arange(N, dtype=torch.int32, device=x.device)[:, None] \
            .expand(*lead, N, d)
    for axis in axes:
        mask, rep = axis_reuse_mask(x_grid, axis, thetas[axis], window,
                                    granularity, channel_groups)
        if axis == "t" and t_valid is not None:
            shape = [1] * x_grid.ndim
            shape[_AXIS_DIM["t"] % x_grid.ndim] = T
            mask = mask & t_valid.to(device=x.device,
                                     dtype=torch.bool).reshape(shape)
        if protected is not None and axis != protect_axis:
            mask = mask & ~protected
        axis_masks[axis] = mask
        take = mask & ~claimed  # first-wins priority
        snapped = torch.where(take, rep, snapped)
        if want_src:
            ax_src = axis_source_tokens(grid, axis, window, x.device)
            src = torch.where(take.reshape(*lead, N, d), ax_src[:, None], src)
        claimed = claimed | mask
    return ReuseResult(
        snapped=snapped.reshape(*lead, N, d),
        mask=claimed.reshape(*lead, N, d),
        axis_masks={a: m.reshape(*lead, N, d) for a, m in axis_masks.items()},
        src_idx=None if src is None else src.contiguous(),
    )



def snap_grid_tokens(x: torch.Tensor, grid: Tuple[int, int, int],
                     thetas: Dict[str, float],
                     grid_slice: Optional[Tuple[int, int]] = None,
                     want_src: bool = False, **kw):
    """:func:`compute_reuse` on the grid tokens ``[s, s + n)`` of a mixed
    text + grid sequence (``grid_slice = (s, n)``; None: every token is a
    grid token).  The other tokens pass through unchanged with mask
    False.  ``kw`` goes to :func:`compute_reuse`.  Returns (snapped,
    mask), both shaped like x, and with ``want_src`` the grid segment's
    (..., n, d) snap-source map in grid-local token indices."""
    if grid_slice is None:
        r = compute_reuse(x, grid, thetas, want_src=want_src, **kw)
        return (r.snapped, r.mask) + ((r.src_idx,) if want_src else ())
    s, n = grid_slice
    r = compute_reuse(x.narrow(-2, s, n), grid, thetas, want_src=want_src,
                      **kw)
    snapped = torch.cat([x.narrow(-2, 0, s), r.snapped,
                         x.narrow(-2, s + n, x.shape[-2] - s - n)], dim=-2)
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    mask.narrow(-2, s, n).copy_(r.mask)
    return (snapped, mask) + ((r.src_idx,) if want_src else ())

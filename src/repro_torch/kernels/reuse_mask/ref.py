"""Plain PyTorch versions of the reuse-snap kernels.

* :func:`reuse_snap_ref` / :func:`reuse_snap_plain` — the single-axis
  pair snap on the pair-split halves / on the whole operand
  (``csrc/reuse_snap.cu``);
* :func:`fused_reuse_ref` — the fused Δ-check + snap: the host pipeline
  ``core.reuse.compute_reuse`` *is* the semantics the fused kernel
  reproduces bit for bit on its eligible shapes.
"""

from __future__ import annotations

import torch

from repro_torch.core.reuse import compute_reuse


def reuse_snap_ref(x_even, x_odd, theta):
    """Window-2 Eq. 3 check + snap along adjacent pairs: Δ = |odd − even|
    · 0.5 in the operands' dtype (each op rounded to it), snap where
    Δ < θ (θ a tensor in that dtype).  Returns (snapped odd, int8 mask)."""
    delta = (x_odd - x_even).abs() * 0.5
    snap = delta < theta
    return torch.where(snap, x_even, x_odd), snap.to(torch.int8)


def reuse_snap_plain(x: torch.Tensor, theta: float):
    """The whole of ``ops.reuse_snap`` on (B, H, N, d): θ rounded to x's
    dtype (through float32, as the JAX wrapper rounds it), the odd half
    snapped by :func:`reuse_snap_ref` and interleaved with the untouched
    even half; the even half's mask is 0."""
    th = torch.tensor(float(theta), dtype=torch.float32).to(x.dtype)
    x_e, x_o = x[..., 0::2, :], x[..., 1::2, :]
    o_o, m_o = reuse_snap_ref(x_e, x_o, th.to(x.device))
    snapped = torch.stack([x_e, o_o], dim=-2).reshape(x.shape)
    mask = torch.stack([torch.zeros_like(m_o), m_o], dim=-2).reshape(x.shape)
    return snapped, mask


def fused_reuse_ref(x, grid, thetas, axes=("t", "x", "y"),
                    granularity="channel"):
    r = compute_reuse(x, grid, thetas, axes=axes, window=2,
                      granularity=granularity)
    return r.snapped, r.mask

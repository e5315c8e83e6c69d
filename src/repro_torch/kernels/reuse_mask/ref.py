"""Plain PyTorch version of the fused Δ-check + snap kernel.

The host pipeline ``core.reuse.compute_reuse`` *is* the semantics the
fused kernel reproduces bit for bit on its eligible shapes.
"""

from __future__ import annotations

from repro_torch.core.reuse import compute_reuse


def fused_reuse_ref(x, grid, thetas, axes=("t", "x", "y"),
                    granularity="channel"):
    r = compute_reuse(x, grid, thetas, axes=axes, window=2,
                      granularity=granularity)
    return r.snapped, r.mask

"""Hand-written CUDA kernels of the port and their launch counters.

``reuse_mask`` holds the fused three-axis Δ-check + snap kernel and
``ripple`` the pair-collapse flash attention kernel; each wrapper counts
the launches of its kernel in a plain module-level integer.
"""

from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels.reuse_mask import ops as reuse_ops
    from repro_torch.kernels.ripple import ops as ripple_ops

    return {"fused_reuse": reuse_ops.launches,
            "ripple_attention": ripple_ops.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels.reuse_mask import ops as reuse_ops
    from repro_torch.kernels.ripple import ops as ripple_ops

    reuse_ops.launches = 0
    ripple_ops.launches = 0

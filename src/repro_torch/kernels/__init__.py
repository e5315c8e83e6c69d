"""Hand-written CUDA kernels of the port and their launch counters.

``reuse_mask`` holds the fused three-axis Δ-check + snap kernel and the
single-axis pair snap, ``ripple`` the pair-collapse flash attention
kernel, ``sparse`` the block-sparse masked attention kernel, ``flash``
the dense flash attention kernel and ``adaln`` the fused adaLN
modulation kernel; each wrapper counts the launches of its kernel in a
plain module-level integer.
"""

from __future__ import annotations

from typing import Dict, Tuple


def _counters() -> Dict[str, Tuple[object, str]]:
    """Kernel name -> (wrapper module, name of its counter)."""
    from repro_torch.kernels.adaln import ops as adaln_ops
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.reuse_mask import ops as reuse_ops
    from repro_torch.kernels.ripple import ops as ripple_ops
    from repro_torch.kernels.sparse import ops as sparse_ops

    return {"fused_reuse": (reuse_ops, "launches"),
            "ripple_attention": (ripple_ops, "launches"),
            "sparse_attention": (sparse_ops, "launches"),
            "adaln": (adaln_ops, "launches"),
            "flash_attention": (flash_ops, "launches"),
            "reuse_snap": (reuse_ops, "snap_launches")}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)

"""Hand-written CUDA kernels of the port and their launch counters.

``reuse_mask`` holds the fused three-axis Δ-check + snap kernel,
``ripple`` the pair-collapse flash attention kernel, ``sparse`` the
block-sparse masked attention kernel and ``adaln`` the fused adaLN
modulation kernel; each wrapper counts the launches of its kernel in a
plain module-level integer.
"""

from __future__ import annotations

from typing import Dict


def _ops():
    from repro_torch.kernels.adaln import ops as adaln_ops
    from repro_torch.kernels.reuse_mask import ops as reuse_ops
    from repro_torch.kernels.ripple import ops as ripple_ops
    from repro_torch.kernels.sparse import ops as sparse_ops

    return {"fused_reuse": reuse_ops, "ripple_attention": ripple_ops,
            "sparse_attention": sparse_ops, "adaln": adaln_ops}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _ops().items()}


def reset_launch_counts() -> None:
    for mod in _ops().values():
        mod.launches = 0

"""Hand-written CUDA kernels of the port and their launch counters.

``reuse_mask`` holds the fused three-axis Δ-check + snap kernel and the
single-axis pair snap, ``ripple`` the pair-collapse flash attention
kernel, ``sparse`` the block-sparse masked attention kernel, ``flash``
the dense flash attention kernel and ``adaln`` the fused adaLN
modulation kernel; each wrapper counts the launches of its kernel in a
plain module-level integer (the ripple and sparse wrappers also by
shape), under :data:`LAUNCH_LOCK`, since router replicas launch from
several engine threads of one process.

Only the adaLN kernel has a gradient (``adaln.ops``: the kernel forward
under an autograd Function, a closed-form backward in PyTorch ops); the
others have none, as their TPU kernels had none, and refuse a CUDA
operand that needs one (:func:`refuse_grad`) rather than detach it.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

LAUNCH_LOCK = threading.Lock()


def refuse_grad(kernel: str, **operands) -> None:
    """Raise when grad mode is on and an operand requires grad: the
    kernel's output would have no ``grad_fn``, so its gradient would
    silently stop there."""
    if not torch.is_grad_enabled():
        return
    needs = [n for n, t in operands.items()
             if isinstance(t, torch.Tensor) and t.requires_grad]
    if needs:
        raise RuntimeError(
            f"the {kernel} kernel has no backward: its operand(s) "
            f"{', '.join(needs)} require grad, and the gradient would stop "
            f"here; call it under torch.no_grad() or detach them")


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
    counters = _counters()
    with LAUNCH_LOCK:
        return {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}


def reset_launch_counts() -> None:
    counters = _counters()
    with LAUNCH_LOCK:
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        for name in ("ripple_attention", "sparse_attention"):
            counters[name][0].launches_by_shape.clear()

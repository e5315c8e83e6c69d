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

The dry run (``launch.dryrun``) counts a step on fake tensors, which no
kernel can read.  Inside :func:`counting_kernels`, which only the dry run
opens, a fake tensor stands for one on the card (:func:`on_card`), and a
wrapper handed one records the call with its kernel's operations and
bytes (``launch.roofline``'s formula, :func:`count_call`) and returns an
empty fake output in place of the launch.  A real tensor takes its path
unchanged, inside the context or out: on the CPU the plain version, on
the card the kernel or an error.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Dict, List, Tuple

import torch

LAUNCH_LOCK = threading.Lock()
_COUNTED: contextvars.ContextVar = contextvars.ContextVar("counted_kernels",
                                                          default=None)


@contextlib.contextmanager
def counting_kernels():
    """The dry run's scope: yields the list that every kernel call on
    fake tensors inside it appends ``(kernel name, KernelWork)`` to."""
    calls: List = []
    token = _COUNTED.set(calls)
    try:
        yield calls
    finally:
        _COUNTED.reset(token)


def counts(t) -> bool:
    """Is ``t`` a fake tensor inside :func:`counting_kernels`?"""
    if _COUNTED.get() is None:
        return False
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def on_card(t: torch.Tensor) -> bool:
    """Does ``t`` take the card's path: a CUDA tensor, or a fake tensor
    that a counted step stands in for one on the card?"""
    return t.is_cuda or counts(t)


def misaligned(t: torch.Tensor, nbytes: int) -> bool:
    """Is ``t``'s data not ``nbytes``-aligned?  A counted fake tensor has
    no data, so never."""
    return not counts(t) and t.data_ptr() % nbytes != 0


def count_call(name: str, work) -> None:
    """Record one call of kernel ``name`` doing ``work`` (a
    ``launch.roofline.KernelWork``); the wrapper then returns empty
    outputs (fake, like its operands) in place of the launch's."""
    _COUNTED.get().append((name, work))


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

"""Wrapper of the dense flash attention kernel (``csrc/flash_attention.cu``),
the dense baseline the ripple and sparse kernels are timed against.

On a CUDA tensor :func:`flash_attention` launches the kernel or raises; on
a CPU tensor, and only there, it runs the plain version (``ref.py``).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (LAUNCH_LOCK, _build, count_call, counts,
                                 misaligned, on_card, refuse_grad)
from repro_torch.kernels.flash.ref import attention_ref, default_scale
from repro_torch.launch.roofline import flash_work

launches = 0

_MAX_DIM = 256  # d and dv apart
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_operands(q, k, v):
    """Raise unless the kernel takes these operands (dtypes, layout,
    shapes, head dims up to ``_MAX_DIM``)."""
    B, H, Nq, d = q.shape
    Nk, dv = k.shape[2], v.shape[3]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"flash kernel takes float32 or bfloat16 "
                            f"operands of one dtype; {name} is {t.dtype}")
        if not t.is_contiguous() or misaligned(t, 16):
            raise ValueError(f"flash kernel needs contiguous, 16-byte "
                             f"aligned operands; {name} is not")
        if t.device != q.device:
            raise ValueError("flash kernel operands must share a device")
    if k.shape != (B, H, Nk, d) or v.shape[:3] != (B, H, Nk):
        raise ValueError(f"flash kernel shapes disagree: q {q.shape}, "
                         f"k {k.shape}, v {v.shape}")
    if Nq < 1 or Nk < 1:
        raise ValueError("flash kernel needs at least one query and key")
    if d > _MAX_DIM or dv > _MAX_DIM:
        raise ValueError(f"flash kernel takes head dims <= {_MAX_DIM}")


def _launch(q, k, v):
    global launches
    _check_operands(q, k, v)
    B, H, Nq, d = q.shape
    Nk, dv = k.shape[2], v.shape[3]
    out = torch.empty((B, H, Nq, dv), dtype=q.dtype, device=q.device)
    if counts(q):  # a dry run's fake operands: counted, not launched
        count_call("flash_attention", flash_work(
            B, H, Nq, Nk, d, dv, str(q.dtype).replace("torch.", "")))
        return out
    fn = _build.function("flash_attention", "flash_attention_launch",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_void_p])
    with _build.on_device(q):  # launch on the operands' card
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B * H, Nq, Nk, d, dv, default_scale(d),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    with LAUNCH_LOCK:
        launches += 1
    return out


def uses_tensor_cores(q: torch.Tensor) -> bool:
    """Does a CUDA call on these operands take the kernel's tensor-core
    path?  The library decides (bf16, any head dims up to 256)."""
    lib = _build.load("flash_attention")
    return bool(lib.flash_uses_tensor_cores(int(q.dtype == torch.bfloat16)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q, k: (B, H, N, d), v: (B, H, Nk, dv) -> (B, H, Nq, dv); Nq != Nk
    and d != dv are allowed.  The scale is ``1 / sqrt(d)``.

    ``block_q`` / ``block_k`` are the reference's tile arguments.  The
    result does not depend on the tile, and the CUDA kernel keeps its own
    (128 query rows by 64 keys), so they are only checked."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive: {block_q}, "
                         f"{block_k}")
    if q.device.type == "cpu" and not counts(q):
        return attention_ref(q, k, v)
    if not on_card(q):
        raise ValueError(f"flash kernel runs on CUDA, not {q.device}")
    refuse_grad("flash_attention", q=q, k=k, v=v)
    return _launch(q, k, v)

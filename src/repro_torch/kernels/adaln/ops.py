"""Wrapper of the fused adaLN modulation kernel (``csrc/adaln.cu``).

``adaln_modulate(x, shift, scale)`` computes
``LayerNorm(x) * (1 + scale) + shift`` per token row, with the (B, d)
conditioning vectors of each sample.  On a CUDA tensor it launches the
kernel or raises; on a CPU tensor, and only there, it runs the plain
version (``ref.py``).  Rows are independent, so any N is taken as it is.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.adaln.ref import adaln_modulate_ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _cond(t: torch.Tensor, x: torch.Tensor):
    """A (B, d) conditioning vector as the kernel reads it, and its stride
    between samples: unit stride along d, every sample's row aligned like
    a row of x (a chunk of the adaLN projection already is; anything else
    is copied)."""
    B, d = t.shape
    if t.stride(-1) != 1 or t.data_ptr() % (4 * x.element_size()) or \
            (B > 1 and (t.stride(0) % 4 or t.stride(0) < d)):
        t = t.contiguous()
    return t, t.stride(0) if B > 1 else d


def _launch(x, shift, scale, eps: float):
    global launches
    B, N, d = x.shape
    for name, t in (("shift", shift), ("scale", scale)):
        if t.dtype != x.dtype:
            raise TypeError(f"adaln kernel takes one dtype; x is {x.dtype}, "
                            f"{name} is {t.dtype}")
        if t.shape != (B, d):
            raise ValueError(f"{name} must be (B, d) = {(B, d)}, not "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("adaln kernel operands must share a device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"adaln kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % (4 * x.element_size()):
        raise ValueError("adaln kernel needs a contiguous, aligned x")
    lib = _build.load("adaln")
    if d % 4 or d > lib.adaln_max_dim():
        raise ValueError(f"adaln kernel takes d % 4 == 0 and d <= "
                         f"{lib.adaln_max_dim()}, not {d}")
    (shift, sh_stride), (scale, sc_stride) = _cond(shift, x), _cond(scale, x)
    out = torch.empty_like(x)
    fn = lib.adaln_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_long] * 2 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):  # launch on the operand's card
        rc = fn(x.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                out.data_ptr(), _DTYPES[x.dtype], B, N, d, sh_stride,
                sc_stride, eps, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adaln kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor,
                   scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (B, N, d); shift/scale: (B, d) -> (B, N, d) in x's dtype."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, d), not {tuple(x.shape)}")
    if x.device.type == "cpu":
        return adaln_modulate_ref(x, shift, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"adaln kernel runs on CUDA, not {x.device}")
    return _launch(x, shift, scale, float(eps))

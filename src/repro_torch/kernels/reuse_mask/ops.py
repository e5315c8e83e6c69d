"""Wrappers of the reuse-snap kernels:

* :func:`reuse_snap` — the single-axis adjacent-pair snap on (B, H, N, d)
  operands (``csrc/reuse_snap.cu``; permute with
  ``core.collapse.pair_major_order`` for the t and y axes first);
  ``snap_launches`` counts its launches;
* :func:`fused_reuse_snap` / :func:`fused_compute_reuse` — the fused
  three-axis Δ-check + snap kernel (``csrc/fused_reuse.cu``), the
  on-device replacement for the host-side ``core.reuse.compute_reuse``
  on its eligible shapes; ``launches`` counts its launches.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor, and only there, it runs the plain version (``ref.py``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.reuse_mask.ref import fused_reuse_ref, reuse_snap_plain

launches = 0
snap_launches = 0

_AXIS_ID = {"t": 0, "x": 1, "y": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _snap_launch(x: torch.Tensor, theta: float):
    global snap_launches
    B, H, N, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"reuse snap kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("reuse snap kernel needs a contiguous, 16-byte "
                         "aligned operand")
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _build.load("reuse_snap")
    fn = lib.reuse_snap_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):  # launch on the operand's card
        rc = fn(x.data_ptr(), out.data_ptr(), mask.data_ptr(),
                _DTYPES[x.dtype], B * H * (N // 2), d, theta,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"reuse snap kernel launch failed: CUDA error "
                           f"{rc}")
    snap_launches += 1
    return out, mask


def reuse_snap(x: torch.Tensor, theta: float):
    """x: (B, H, N, d) with N even, theta: scalar -> (snapped x, mask int8),
    both shaped like x.  Each odd token whose Δ = |x_odd − x_even| · 0.5 is
    below θ (rounded to x's dtype) takes its even partner's value; the
    even (representative) tokens are untouched and never masked."""
    if x.dim() != 4 or x.shape[2] % 2:
        raise ValueError(f"reuse_snap takes (B, H, N, d) with N even, not "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return reuse_snap_plain(x, theta)
    if x.device.type != "cuda":
        raise ValueError(f"reuse snap kernel runs on CUDA, not {x.device}")
    th = torch.tensor(float(theta), dtype=torch.float32).to(x.dtype)
    return _snap_launch(x, float(th))


def fused_reuse_eligible(grid: Tuple[int, int, int], *, window: int = 2,
                         granularity: str = "channel",
                         axes: Sequence[str] = ("t", "x", "y")) -> bool:
    """Can the fused kernel reproduce ``compute_reuse`` for this setup?

    Window 2, channel/token granularity (the RoPE-'group' gate stays on
    the host path), even H and W, and an even frame count whenever the
    temporal check is active (T == 1 is fine: the t check never fires).
    """
    T, H, W = grid
    if window != 2 or granularity not in ("channel", "token"):
        return False
    if H < 2 or H % 2 or W < 2 or W % 2:
        return False
    if "t" in axes and T > 1 and T % 2:
        return False
    return set(axes) <= {"t", "x", "y"}


def _launch(x: torch.Tensor, thetas: Sequence[float], grid, axes,
            granularity: str):
    global launches
    T, H, W = grid
    *lead, N, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused reuse kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused reuse kernel needs a contiguous operand")
    if not fused_reuse_eligible(grid, granularity=granularity, axes=axes):
        raise ValueError(f"grid {grid} / granularity {granularity!r} / "
                         f"axes {axes} not eligible for the fused kernel")
    if d > 256:
        raise ValueError(f"fused reuse kernel takes head_dim <= 256, not {d}")
    with_t = "t" in axes and T >= 2
    TT = 2 if with_t else 1
    G = (math.prod(lead) if lead else 1) * (T // TT)
    th = torch.tensor([float(t) for t in thetas], dtype=torch.float32)
    th = th.to(x.dtype).float().tolist()  # θ in the working type
    code = 0
    for i, a in enumerate(axes):
        code |= _AXIS_ID[a] << (2 * i)
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    lib = _build.load("fused_reuse")
    fn = lib.fused_reuse_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    with torch.cuda.device(x.device):  # launch on the operand's card
        rc = fn(x.data_ptr(), out.data_ptr(), mask.data_ptr(),
                _DTYPES[x.dtype], G, TT, H, W, d, th[0], th[1], th[2], code,
                len(axes), int(granularity == "token"),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_reuse kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out, mask


def fused_reuse_snap(x: torch.Tensor, thetas: Sequence[float], *,
                     grid: Tuple[int, int, int],
                     axes: Tuple[str, ...] = ("t", "x", "y"),
                     granularity: str = "channel"):
    """x: (..., N, d) grid tokens in (t, y, x) row-major order; thetas:
    (θt, θx, θy).  Returns (snapped, mask: bool) shaped like x."""
    T, H, W = grid
    if x.shape[-2] != T * H * W:
        raise ValueError(f"token count {x.shape[-2]} != grid {grid}")
    if x.device.type == "cpu":
        return fused_reuse_ref(x, grid, dict(zip("txy", thetas)),
                               axes=axes, granularity=granularity)
    if x.device.type != "cuda":
        raise ValueError(f"fused reuse kernel runs on CUDA, not {x.device}")
    return _launch(x, thetas, grid, tuple(axes), granularity)


def fused_compute_reuse(x: torch.Tensor, grid: Tuple[int, int, int],
                        thetas: Dict[str, float], *,
                        axes: Sequence[str] = ("t", "x", "y"),
                        granularity: str = "channel"):
    """Dict-θ convenience mirroring ``compute_reuse``'s signature; returns
    (snapped, mask).  Callers check :func:`fused_reuse_eligible` first."""
    th = [float(thetas.get(a, 0.0)) for a in ("t", "x", "y")]
    return fused_reuse_snap(x, th, grid=grid, axes=tuple(axes),
                            granularity=granularity)

"""Wrappers of the reuse-snap kernels:

* :func:`reuse_snap` — the single-axis adjacent-pair snap on (B, H, N, d)
  operands (``csrc/reuse_snap.cu``; permute with
  ``core.collapse.pair_major_order`` for the t and y axes first);
  ``snap_launches`` counts its launches;
* :func:`fused_reuse_snap` / :func:`fused_compute_reuse` — the fused
  three-axis Δ-check + snap kernel (``csrc/fused_reuse.cu``), the
  on-device replacement for the host-side ``core.reuse.compute_reuse``
  on its eligible shapes; it reads the operand in place through its
  strides and, given a ``grid_slice``, snaps the grid tokens of a mixed
  text + grid sequence and copies the text tokens through; with
  ``want_src`` the same launch writes the grid tokens' int32 snap-source
  map (``compute_reuse(want_src=True).src_idx``); ``launches`` counts
  its launches.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor, and only there, it runs the plain version (``ref.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import (LAUNCH_LOCK, _build, count_call, counts,
                                 misaligned, on_card, refuse_grad)
from repro_torch.kernels.reuse_mask.ref import fused_reuse_ref, reuse_snap_plain
from repro_torch.launch.roofline import reuse_work, snap_work

launches = 0
snap_launches = 0

_AXIS_ID = {"t": 0, "x": 1, "y": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Priority permutations of the axis ids, indexed as the kernel's
# order_axis() indexes them.
_ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FUSED_ARGS = [_P] * 4 + [_I] * 3 + [_L] * 3 + [_I] * 7 + [_F] * 3 \
    + [_I] * 2 + [_P]
_SNAP_ARGS = [_P] * 3 + [_I] * 3 + [_F, _P]


def round_to(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to float32 and then, for bfloat16, to nearest-even
    bfloat16, as ``torch.tensor(v, dtype=torch.float32).to(dtype)`` rounds
    it; returned as a Python float."""
    f = np.float32(v)
    if dtype == torch.bfloat16 and np.isfinite(f):
        b = int(f.view(np.uint32))
        b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
        f = np.uint32(b).view(np.float32)
    return float(f)


def _snap_launch(x: torch.Tensor, theta: float):
    global snap_launches
    B, H, N, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"reuse snap kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if not x.is_contiguous() or misaligned(x, 16):
        raise ValueError("reuse snap kernel needs a contiguous, 16-byte "
                         "aligned operand")
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if counts(x):  # a dry run's fake operand: counted, not launched
        count_call("reuse_snap", snap_work(x.shape, x.element_size()))
        return out, mask
    fn = _build.function("reuse_snap", "reuse_snap_launch", _SNAP_ARGS)
    with _build.on_device(x):  # launch on the operand's card
        rc = fn(x.data_ptr(), out.data_ptr(), mask.data_ptr(),
                _DTYPES[x.dtype], B * H * (N // 2), d, theta,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"reuse snap kernel launch failed: CUDA error "
                           f"{rc}")
    with LAUNCH_LOCK:
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
    if x.device.type == "cpu" and not counts(x):
        return reuse_snap_plain(x, theta)
    if not on_card(x):
        raise ValueError(f"reuse snap kernel runs on CUDA, not {x.device}")
    refuse_grad("reuse_snap", x=x)
    return _snap_launch(x, round_to(theta, x.dtype))


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


def _lead_dims(x: torch.Tensor):
    """x's lead dims as two strided dims ``(n0, n1, s0, s1)`` (size-1 dims
    dropped, neighbours merged where their strides chain), or None when
    they do not fit in two."""
    dims = []
    for n, st in zip(x.shape[:-2], x.stride()[:-2]):
        if n == 1:
            continue
        if dims and dims[-1][1] == st * n:
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > 2:
        return None
    (n0, s0), (n1, s1) = [(1, 0)] * (2 - len(dims)) + dims
    return n0, n1, s0, s1


def _launch(x: torch.Tensor, thetas: Sequence[float], grid, axes,
            granularity: str, grid_slice: Tuple[int, int], want_src: bool):
    global launches
    T, H, W = grid
    *_, N, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused reuse kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if not fused_reuse_eligible(grid, granularity=granularity, axes=axes):
        raise ValueError(f"grid {grid} / granularity {granularity!r} / "
                         f"axes {axes} not eligible for the fused kernel")
    if d > 256:
        raise ValueError(f"fused reuse kernel takes head_dim <= 256, not {d}")
    lead = _lead_dims(x)
    if lead is None or (d > 1 and x.stride(-1) != 1):
        # Only a view the kernel cannot address (more than two lead dims
        # that do not merge, or strided channels) is copied first.
        x = x.contiguous()
        lead = _lead_dims(x)
    n0, n1, s0, s1 = lead
    TT = 2 if "t" in axes and T >= 2 else 1
    order = [_AXIS_ID[a] for a in axes]
    order += [i for i in range(3) if i not in order]
    th = [round_to(thetas[i], x.dtype) if a in axes else 0.0
          for i, a in enumerate("txy")]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    src = (torch.empty((*x.shape[:-2], grid_slice[1], d), dtype=torch.int32,
                       device=x.device) if want_src else None)
    if counts(x):  # a dry run's fake operand: counted, not launched
        count_call("fused_reuse", reuse_work(x.shape, x.element_size(), grid,
                                             want_src))
        return (out, mask) + ((src,) if want_src else ())
    fn = _build.function("fused_reuse", "fused_reuse_launch", _FUSED_ARGS)
    with _build.on_device(x):  # launch on the operand's card
        rc = fn(x.data_ptr(), out.data_ptr(), mask.data_ptr(),
                None if src is None else src.data_ptr(), _DTYPES[x.dtype], n0, n1, s0, s1, x.stride(-2), N,
                grid_slice[0], T, TT, H, W, d, *th,
                _ORDERS.index(tuple(order)), int(granularity == "token"),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_reuse kernel launch failed: CUDA error "
                           f"{rc}")
    with LAUNCH_LOCK:
        launches += 1
    return (out, mask) + ((src,) if want_src else ())


def fused_reuse_snap(x: torch.Tensor, thetas: Sequence[float], *,
                     grid: Tuple[int, int, int],
                     axes: Tuple[str, ...] = ("t", "x", "y"),
                     granularity: str = "channel",
                     grid_slice: Optional[Tuple[int, int]] = None,
                     want_src: bool = False):
    """x: (..., N, d), any strides; its tokens ``[s, s + T*H*W)`` are grid
    tokens in (t, y, x) row-major order (``grid_slice = (s, T*H*W)``;
    None: all N tokens are); thetas: (θt, θx, θy).  Returns (snapped,
    mask: bool) shaped like x: the grid tokens snapped, the others
    unchanged with mask False; with ``want_src`` also the grid tokens'
    (..., T*H*W, d) int32 snap-source map in grid-local token indices,
    by which gathering the grid segment gives its snapped values."""
    T, H, W = grid
    N = x.shape[-2]
    s, n = grid_slice if grid_slice is not None else (0, N)
    if n != T * H * W or s < 0 or s + n > N:
        raise ValueError(f"grid slice {(s, n)} of {N} tokens does not hold "
                         f"grid {grid}")
    if x.device.type == "cpu" and not counts(x):
        return fused_reuse_ref(x, grid, dict(zip("txy", thetas)), axes=axes,
                               granularity=granularity, grid_slice=grid_slice,
                               want_src=want_src)
    if not on_card(x):
        raise ValueError(f"fused reuse kernel runs on CUDA, not {x.device}")
    refuse_grad("fused_reuse", x=x)
    return _launch(x, thetas, grid, tuple(axes), granularity, (s, n),
                   want_src)


def fused_compute_reuse(x: torch.Tensor, grid: Tuple[int, int, int],
                        thetas: Dict[str, float], *,
                        axes: Sequence[str] = ("t", "x", "y"),
                        granularity: str = "channel",
                        grid_slice: Optional[Tuple[int, int]] = None,
                        want_src: bool = False):
    """Dict-θ convenience mirroring ``compute_reuse``'s signature; returns
    (snapped, mask), and the source map with ``want_src``.  Callers check
    :func:`fused_reuse_eligible` first."""
    th = [float(thetas.get(a, 0.0)) for a in ("t", "x", "y")]
    return fused_reuse_snap(x, th, grid=grid, axes=tuple(axes),
                            granularity=granularity, grid_slice=grid_slice,
                            want_src=want_src)

"""Wrapper of the ripple pair-collapse attention kernel
(``csrc/ripple_attention.cu``).

Takes standard (B, H, N, d) snapped operands, derives the per-tile
collapse flags from value equality (plain PyTorch, as the JAX package
does outside its Pallas call), and launches the kernel, which reads the
even/odd tokens in place and masks the ragged last tile by index.  On a
CUDA tensor it launches the kernel or raises; on a CPU tensor, and only
there, it runs the plain version (``ref.py``).  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ripple.ref import (block_flags, full_block_flags,
                                            ripple_attention_ref, split_pairs)

launches = 0

# Pairs per query tile and per key tile: the kernel's compile-time tile
# (``kTile`` in ripple_attention.cu), also the granularity of the flags.
TILE_PAIRS = 32
_MAX_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_scale(head_dim: int) -> float:
    """Softmax scale 1/sqrt(d), computed in float32 as the JAX dispatch
    computes it; the one value both the kernel and the plain version use."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def _launch(q, k, v, scale: float):
    global launches
    B, H, N, d = q.shape
    dv = v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"ripple kernel takes float32 or bfloat16 "
                            f"operands of one dtype; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ripple kernel needs contiguous operands; "
                             f"{name} is not")
        if t.device != q.device:
            raise ValueError("ripple kernel operands must share a device")
    if k.shape != (B, H, N, d) or v.shape[:3] != (B, H, N):
        raise ValueError(f"ripple kernel is self-attention: q {q.shape}, "
                         f"k {k.shape}, v {v.shape}")
    if N % 2:
        raise ValueError("pair-collapse needs an even token count")
    if d > _MAX_DIM or dv > _MAX_DIM:
        raise ValueError(f"ripple kernel takes head dims <= {_MAX_DIM}")
    lib = _build.load("ripple_attention")
    if lib.ripple_tile_pairs() != TILE_PAIRS:
        raise RuntimeError("ripple kernel tile does not match TILE_PAIRS")
    BH = B * H
    qflags = block_flags(q.reshape(BH, N, d), TILE_PAIRS).contiguous()
    kflags = block_flags(k.reshape(BH, N, d), TILE_PAIRS).contiguous()
    out = torch.empty((B, H, N, dv), dtype=q.dtype, device=q.device)
    fn = lib.ripple_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):  # launch on the operands' card
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                qflags.data_ptr(), kflags.data_ptr(), _DTYPES[q.dtype], BH,
                N, d, dv, scale, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ripple attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def uses_tensor_cores(q: torch.Tensor, v: torch.Tensor) -> bool:
    """Does a CUDA call on these operands take the kernel's tensor-core
    path?  The library decides (bf16, equal head dims of 32, 64, 72 or
    128)."""
    lib = _build.load("ripple_attention")
    return bool(lib.ripple_uses_tensor_cores(int(q.dtype == torch.bfloat16),
                                             q.shape[-1], v.shape[-1]))


def ripple_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     bias=None, window: int = 2, scale=None) -> torch.Tensor:
    """q, k, v: (B, H, N, d) snapped operands -> (B, H, N, dv)."""
    if bias is not None:
        raise ValueError("the ripple kernel path does not take a bias")
    if window != 2:
        raise ValueError("the ripple kernel implements window 2 only")
    if scale is None:
        scale = attention_scale(q.shape[-1])
    if q.device.type == "cpu":
        return ripple_attention_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"ripple kernel runs on CUDA, not {q.device}")
    return _launch(q, k, v, float(scale))


def ripple_tile_stats(q: torch.Tensor, k: torch.Tensor, dv: int):
    """(query tiles collapsed, key tiles collapsed, flops) for one call:
    the work these operands need, counting 2 flops per multiply-add of
    the score and PV products over the rows and keys a collapsed tile
    leaves."""
    B, H, N, d = q.shape
    qf = block_flags(q.reshape(B * H, N, d), TILE_PAIRS).float()
    kf = block_flags(k.reshape(B * H, N, d), TILE_PAIRS).float()
    P = N // 2
    nb = qf.shape[1]
    last = P - (nb - 1) * TILE_PAIRS  # real pairs in the last tile
    pairs = torch.full((nb,), float(TILE_PAIRS), device=q.device)
    pairs[-1] = last
    rows = pairs * (2.0 - qf)  # (BH, nb) rows computed per query tile
    keys = pairs * (2.0 - kf)  # (BH, nb) keys per key tile
    flops = 2.0 * rows.sum(1) * keys.sum(1) * (d + dv)
    return qf.mean().item(), kf.mean().item(), flops.sum().item()


def ripple_block_stats(q: torch.Tensor, k: torch.Tensor, *,
                       block_q: int = 128, block_k: int = 128
                       ) -> torch.Tensor:
    """Fraction of the reference's block matmul work that its pair-collapse
    kernel skips for these operands, at its block size (pairs): per (q, k)
    block pair the dense cost is 8 block products; the row halves computed
    are 2 − qc and each costs 2 products when the key block collapsed, 4
    otherwise.  Only whole blocks count, as in the JAX package; the port's
    own kernel tiles by ``TILE_PAIRS`` (see :func:`ripple_tile_stats`)."""
    B, H, N, d = q.shape
    q_e, q_o = split_pairs(q.reshape(B * H, N, d))
    k_e, k_o = split_pairs(k.reshape(B * H, N, d))
    P = N // 2
    bq, bk = min(block_q, P), min(block_k, P)
    qc = full_block_flags(q_e, q_o, bq).float()
    kc = full_block_flags(k_e, k_o, bk).float()
    halves = (2.0 - qc)[:, :, None]                            # (BH, nq, 1)
    per_half = torch.where(kc[:, None, :] > 0, 2.0, 4.0)       # (BH, 1, nk)
    return 1.0 - (halves * per_half).mean() / 8.0

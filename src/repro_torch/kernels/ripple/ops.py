"""Wrapper of the ripple pair-collapse attention kernel
(``csrc/ripple_attention.cu``).

Takes standard (B, H, N, d) snapped operands, derives the per-tile
collapse flags from value equality (plain PyTorch, as the JAX package
does outside its Pallas call: key flags always, query flags only for the
CUDA-core path, since the tensor-core path computes follower rows in any
case), and launches the kernel, which reads the even/odd tokens in place
and masks the ragged last tile by index.  On a
CUDA tensor it launches the kernel or raises; on a CPU tensor, and only
there, it runs the plain version (``ref.py``).  ``launches`` counts
kernel launches, ``launches_by_shape`` the same launches by (tokens, head
dim).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import (LAUNCH_LOCK, _build, count_call, counts,
                                 on_card, refuse_grad)
from repro_torch.launch.roofline import ripple_work
from repro_torch.kernels.ripple.ref import (block_flags, full_block_flags,
                                            ripple_attention_ref, split_pairs)

launches = 0
launches_by_shape: dict = {}

# Pairs per flag: the tensor-core path's query tile and key stage
# (``kFlagTile`` in ripple_attention.cu; the CUDA-core path runs 32-pair
# halves of it).
TILE_PAIRS = 64
# A failed tensor-map encode returns this plus its CUresult.
_ENCODE_ERROR = 10000
# The largest head dim either path takes (``kMaxDim``), the fused Δ-check
# kernel's too: every head dim a config of the repo serves.
_MAX_DIM = 256
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
    BH = B * H
    kflags = block_flags(k.reshape(BH, N, d), TILE_PAIRS).contiguous()
    if counts(q):  # a dry run's fake operands: counted with no tile collapsed
        count_call("ripple_attention", ripple_work(q.shape, dv,
                                                   q.element_size()))
        return torch.empty((B, H, N, dv), dtype=q.dtype, device=q.device)
    lib = _build.load("ripple_attention")
    if lib.ripple_tile_pairs() != TILE_PAIRS:
        raise RuntimeError("ripple kernel tile does not match TILE_PAIRS")
    qflags = None
    if not lib.ripple_uses_tensor_cores(_DTYPES[q.dtype], d, dv):
        qflags = block_flags(q.reshape(BH, N, d), TILE_PAIRS).contiguous()
    out = torch.empty((B, H, N, dv), dtype=q.dtype, device=q.device)
    fn = _build.function("ripple_attention", "ripple_attention_launch",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                         + [ctypes.c_float, ctypes.c_void_p])
    with _build.on_device(q):  # launch on the operands' card
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                0 if qflags is None else qflags.data_ptr(),
                kflags.data_ptr(), _DTYPES[q.dtype], BH, N, d, dv, scale,
                torch.cuda.current_stream().cuda_stream)
    if rc >= _ENCODE_ERROR:
        raise RuntimeError(f"ripple attention kernel: cuTensorMapEncodeTiled "
                           f"failed with CUresult {rc - _ENCODE_ERROR}")
    if rc != 0:
        raise RuntimeError(f"ripple attention kernel launch failed: CUDA "
                           f"error {rc}")
    with LAUNCH_LOCK:
        launches += 1
        launches_by_shape[(N, d)] = launches_by_shape.get((N, d), 0) + 1
    return out


def uses_tensor_cores(q: torch.Tensor, v: torch.Tensor) -> bool:
    """Does a CUDA call on these operands take the kernel's tensor-core
    path?  The library decides (bf16, equal head dims of 32, 40, 64, 72,
    80, 128 or 160)."""
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
    if q.device.type == "cpu" and not counts(q):
        return ripple_attention_ref(q, k, v, scale)
    if not on_card(q):
        raise ValueError(f"ripple kernel runs on CUDA, not {q.device}")
    refuse_grad("ripple_attention", q=q, k=k, v=v)
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

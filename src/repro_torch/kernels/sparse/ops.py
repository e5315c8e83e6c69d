"""Wrapper of the block-sparse masked attention kernel
(``csrc/sparse_attention.cu``), and the policy-facing helpers:

* :func:`block_map_from_keep` — tile a boolean keep-mask into the
  kernel's SKIP/FULL/PARTIAL states (how SVG's head-classified masks
  become a block map, DESIGN.md §12);
* :func:`sparse_block_stats` — the fraction of tiles the kernel skips.

On a CUDA tensor :func:`sparse_attention` launches the kernel or raises;
on a CPU tensor, and only there, it runs the plain version (``ref.py``).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparse.ref import (FULL, PARTIAL, SKIP,
                                            sparse_attention_ref,
                                            sparse_grid)

__all__ = ["FULL", "PARTIAL", "SKIP", "block_map_from_keep",
           "sparse_attention", "sparse_block_stats", "sparse_grid"]

launches = 0

_MAX_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def block_map_from_keep(keep: torch.Tensor, block_q: int,
                        block_k: int) -> torch.Tensor:
    """(..., Nq, Nk) bool keep-mask -> (..., nq, nk) int32 block map.

    A tile that keeps everything is FULL (mask-free fast path), one that
    keeps nothing is SKIP, anything mixed is PARTIAL (the −inf bias is
    applied in the kernel).  Ragged edges are padded with the edge value
    so padding can never flip a FULL/SKIP verdict to PARTIAL.
    """
    *lead, n_q, n_k = keep.shape
    bq, bk, nq, nk = sparse_grid(n_q, n_k, block_q, block_k)
    if nq * bq != n_q:
        rows = torch.arange(nq * bq, device=keep.device).clamp_(max=n_q - 1)
        keep = keep.index_select(-2, rows)
    if nk * bk != n_k:
        cols = torch.arange(nk * bk, device=keep.device).clamp_(max=n_k - 1)
        keep = keep.index_select(-1, cols)
    tiled = keep.reshape(*lead, nq, bq, nk, bk)
    any_keep = tiled.any(dim=-1).any(dim=-2)
    all_keep = tiled.all(dim=-1).all(dim=-2)
    return torch.where(all_keep, FULL,
                       torch.where(any_keep, PARTIAL, SKIP)).to(torch.int32)


def sparse_block_stats(block_map: torch.Tensor) -> torch.Tensor:
    """Fraction of (q_block, k_block) tiles the kernel skips outright —
    score product, softmax update and PV product all elided."""
    return (block_map == SKIP).float().mean()


def _check_operands(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"sparse kernel takes float32 or bfloat16 "
                            f"operands of one dtype; {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"sparse kernel needs contiguous, 16-byte "
                             f"aligned operands; {name} is not")
        if t.device != q.device:
            raise ValueError("sparse kernel operands must share a device")
    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    if k.shape != (B, H, Nk, d) or v.shape[:3] != (B, H, Nk):
        raise ValueError(f"sparse kernel operands do not match: q {q.shape}, "
                         f"k {k.shape}, v {v.shape}")
    if d > _MAX_DIM or v.shape[3] > _MAX_DIM:
        raise ValueError(f"sparse kernel takes head dims <= {_MAX_DIM}")


def _launch(q, k, v, bias, block_map, block_q: int, block_k: int):
    global launches
    _check_operands(q, k, v)
    B, H, Nq, d = q.shape
    Nk, dv = k.shape[2], v.shape[3]
    bq, bk, nq, nk = sparse_grid(Nq, Nk, block_q, block_k)
    if block_map is None:
        state = PARTIAL if bias is not None else FULL
        bmap = torch.full((B, H, nq, nk), state, dtype=torch.int32,
                          device=q.device)
    else:
        bmap = block_map.to(device=q.device, dtype=torch.int32) \
            .expand(B, H, nq, nk).contiguous()
    sb = sh = 0
    if bias is not None:
        # Broadcast over batch and heads through strides, never copied;
        # each (row, key) row must be a dense run of Nk floats.
        bias = bias.to(device=q.device, dtype=torch.float32) \
            .expand(B, H, Nq, Nk)
        if bias.stride(3) != 1 or bias.stride(2) != Nk:
            bias = bias.contiguous()
        sb, sh = bias.stride(0), bias.stride(1)
    out = torch.empty((B, H, Nq, dv), dtype=q.dtype, device=q.device)
    lib = _build.load("sparse_attention")
    fn = lib.sparse_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):  # launch on the operands' card
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                bmap.data_ptr(), _DTYPES[q.dtype], B * H, H, Nq, Nk, d, dv,
                bq, bk, sb, sh, float(1.0 / (d ** 0.5)),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sparse attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def uses_tensor_cores(q: torch.Tensor, v: torch.Tensor) -> bool:
    """Does a CUDA call on these operands take the kernel's tensor-core
    path?  The library decides (bf16, equal head dims of 32, 64 or 128)."""
    lib = _build.load("sparse_attention")
    return bool(lib.sparse_uses_tensor_cores(int(q.dtype == torch.bfloat16),
                                             q.shape[-1], v.shape[-1]))


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     bias=None, block_map=None, block_q: int = 128,
                     block_k: int = 128, carry=None,
                     return_state: bool = False) -> torch.Tensor:
    """q, k, v: (B, H, N, d) -> (B, H, Nq, dv).

    ``block_map``: (..., nq, nk) int states broadcastable over (B, H),
    tiled as :func:`sparse_grid` tiles the (Nq, Nk) score map.  ``None``
    degrades gracefully: all-PARTIAL when a ``bias`` exists (dense
    masked attention), all-FULL otherwise.  ``bias`` is additive on
    logits, broadcastable to (B, H, Nq, Nk), and read only inside
    PARTIAL tiles — FULL tiles must correspond to an all-zero bias
    region, SKIP tiles to all −inf (``block_map_from_keep`` guarantees
    both).  The scale is the JAX wrapper's ``1 / d ** 0.5`` (a Python
    double, rounded to f32 by the kernel).

    ``carry`` / ``return_state`` (the ring's cross-hop accumulator)
    are not ported yet and raise.
    """
    if carry is not None or return_state:
        raise NotImplementedError(
            "the sparse kernel's carry / return_state contract waits for "
            "the multi-GPU slice (ring attention)")
    if q.device.type == "cpu":
        return sparse_attention_ref(q, k, v, bias=bias, block_map=block_map,
                                    block_q=block_q, block_k=block_k,
                                    scale=float(1.0 / (q.shape[-1] ** 0.5)))
    if q.device.type != "cuda":
        raise ValueError(f"sparse kernel runs on CUDA, not {q.device}")
    return _launch(q, k, v, bias, block_map, block_q, block_k)

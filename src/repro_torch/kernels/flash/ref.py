"""Plain PyTorch version of the flash attention kernel: the JAX package's
``kernels/flash/ref.py::attention_ref``."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def default_scale(head_dim: int) -> float:
    """``1 / sqrt(d)`` computed in double and rounded to float32, as the
    JAX wrapper's Python-float scale is when it multiplies f32 logits."""
    return float(np.float32(1.0 / head_dim ** 0.5))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (..., Nq, d), k: (..., Nk, d), v: (..., Nk, dv) -> (..., Nq, dv).
    The logits come out of the product in the operands' dtype and are
    scaled in float32; the probabilities are cast to v's dtype before the
    PV product."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)

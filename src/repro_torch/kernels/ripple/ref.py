"""Plain PyTorch version of the ripple (pair-collapse) attention kernel.

The collapse identities are exact (DESIGN.md §2), so the plain version
is dense softmax attention on the *snapped* operands; any deviation of
the kernel from it beyond summation order is a bug.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def ripple_attention_ref(q_snapped: torch.Tensor, k_snapped: torch.Tensor,
                         v: torch.Tensor, scale: Optional[float] = None
                         ) -> torch.Tensor:
    if scale is None:
        scale = 1.0 / math.sqrt(q_snapped.shape[-1])
    s = torch.matmul(q_snapped, k_snapped.transpose(-1, -2))
    p = torch.softmax(s.float() * scale, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def split_pairs(x: torch.Tensor):
    """(..., N, d) -> even/odd (..., N/2, d); N must be even."""
    return x[..., 0::2, :], x[..., 1::2, :]


def block_flags(x: torch.Tensor, block: int) -> torch.Tensor:
    """(BH, N, d) operand -> (BH, ceil(N/2 / block)) int32; 1 where every
    pair of the block is value-identical (follower fully snapped).  The
    last block may be partial: only its real pairs count."""
    x_even, x_odd = split_pairs(x)
    eq = (x_even == x_odd).all(dim=-1)  # (BH, P)
    BH, P = eq.shape
    nb = -(-P // block)
    pad = nb * block - P
    if pad:
        eq = torch.cat([eq, eq.new_ones((BH, pad))], dim=1)
    return eq.reshape(BH, nb, block).all(dim=-1).to(torch.int32)

"""Plain PyTorch version of the fused adaLN modulation kernel: a copy of
the JAX package's ``kernels/adaln/ref.py``."""

from __future__ import annotations

import torch


def adaln_modulate_ref(x: torch.Tensor, shift: torch.Tensor,
                       scale: torch.Tensor, eps: float = 1e-6
                       ) -> torch.Tensor:
    """x: (B, N, d); shift/scale: (B, d).  LayerNorm without parameters
    in float32, then ``* (1 + scale) + shift``, rounded once to x's
    dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    norm = (x32 - mu) / torch.sqrt(var + eps)
    out = norm * (1.0 + scale[:, None, :].float()) \
        + shift[:, None, :].float()
    return out.to(x.dtype)

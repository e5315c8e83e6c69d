"""Convolution substrate of the UNet, NHWC throughout as in the JAX
package's ``repro/models/conv.py``.

:class:`Conv` keeps its weight ``w`` in PyTorch's (c_out, c_in, k, k)
layout, the JAX package's (k, k, c_in, c_out) HWIO leaf transposed
(``models.params`` converts), and its bias ``b``.  :func:`conv2d` runs
``F.conv2d`` on the NHWC activation seen as a channels-last NCHW tensor
(a view: no copy), with the reference's ``"SAME"`` padding;
:func:`groupnorm` and :func:`upsample_nearest` are plain tensor ops, as
the reference computes them in jnp.  The reference leaves all three to
XLA outside any Pallas kernel, so they have no kernel of their own here
either.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import param


class Conv(nn.Module):
    """A k x k convolution: ``w`` (c_out, c_in, k, k) and ``b`` (c_out,)."""

    def __init__(self, k: int, c_in: int, c_out: int, device=None,
                 dtype=None):
        super().__init__()
        self.w = param(c_out, c_in, k, k, device=device, dtype=dtype)
        self.b = param(c_out, device=device, dtype=dtype)


class Norm(nn.Module):
    """A GroupNorm's or LayerNorm's affine leaves ``scale`` and ``bias``
    (c,)."""

    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        self.scale = param(c, device=device, dtype=dtype)
        self.bias = param(c, device=device, dtype=dtype)


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after), the
    odd pixel after.  Even inputs at k 3, stride 2 pad (0, 1), which
    ``F.conv2d(padding=1)`` would not."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(conv: Conv, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: (B, H, W, c_in) -> (B, H', W', c_out) in x's dtype, ``"SAME"``
    padded; the bias is added by the convolution."""
    w = conv.w.to(x.dtype)
    k = w.shape[-1]
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor
    ph = same_padding(x.shape[1], k, stride)
    pw = same_padding(x.shape[2], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        out = F.conv2d(xc, w, conv.b.to(x.dtype), stride=stride,
                       padding=(ph[0], pw[0]))
    else:
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        out = F.conv2d(xc, w, conv.b.to(x.dtype), stride=stride)
    return out.permute(0, 2, 3, 1)


def groupnorm(gn: Norm, x: torch.Tensor, groups: int = 32,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of NHWC x: ``groups`` groups (fewer while they do not
    divide C), float32 statistics over (H, W, C/g), one rounding back to
    x's dtype."""
    B, H, W, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    x32 = x.float().reshape(B, H * W, g, C // g)
    var, mu = torch.var_mean(x32, dim=(1, 3), unbiased=False, keepdim=True)
    out = ((x32 - mu) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return (out * gn.scale.float() + gn.bias.float()).to(x.dtype)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*f, W*f, C), each pixel repeated f x f."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, factor, W, factor, C)
    return x.reshape(B, H * factor, W * factor, C)

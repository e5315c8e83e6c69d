"""Convolution substrate of the UNet and EfficientNet, NHWC throughout as
in the JAX package's ``repro/models/conv.py``.

:class:`Conv` keeps its weight ``w`` in PyTorch's (c_out, c_in, k, k)
layout, the JAX package's (k, k, c_in, c_out) HWIO leaf transposed
(``models.params`` converts); a depthwise convolution's (k, k, 1, C)
leaf becomes (C, 1, k, k), run with C groups.  The bias ``b`` is
optional, as in the JAX ``conv_defs``.  :func:`conv2d` runs
``F.conv2d`` on the NHWC activation seen as a channels-last NCHW tensor
(a view: no copy), with the reference's ``"SAME"`` padding;
:func:`groupnorm`, :func:`batchnorm`, :func:`global_avg_pool` and
:func:`upsample_nearest` are plain tensor ops, as the reference computes
them in jnp.  The reference leaves all of them to XLA outside any Pallas
kernel, so they have no kernel of their own here either.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import Norm, param


class Conv(nn.Module):
    """A k x k convolution: ``w`` (c_out, c_in, k, k), or (c_in, 1, k, k)
    with ``depthwise`` (c_out == c_in, one group a channel), and ``b``
    (c_out,) unless ``bias=False``."""

    def __init__(self, k: int, c_in: int, c_out: int, device=None,
                 dtype=None, bias: bool = True, depthwise: bool = False):
        super().__init__()
        self.groups = c_in if depthwise else 1
        self.w = param(c_out, c_in // self.groups, k, k, device=device,
                       dtype=dtype)
        self.b = param(c_out, device=device, dtype=dtype) if bias else None


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after), the
    odd pixel after.  Even inputs at k 3, stride 2 pad (0, 1), which
    ``F.conv2d(padding=1)`` would not."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(conv: Conv, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: (B, H, W, c_in) -> (B, H', W', c_out) in x's dtype, ``"SAME"``
    padded; the bias, where there is one, is added by the convolution."""
    w = conv.w.to(x.dtype)
    b = conv.b.to(x.dtype) if conv.b is not None else None
    k = w.shape[-1]
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor
    ph = same_padding(x.shape[1], k, stride)
    pw = same_padding(x.shape[2], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        out = F.conv2d(xc, w, b, stride=stride, padding=(ph[0], pw[0]),
                       groups=conv.groups)
    else:
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        out = F.conv2d(xc, w, b, stride=stride, groups=conv.groups)
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


def batchnorm(bn: Norm, x: torch.Tensor, eps: float = 1e-3,
              group=None) -> torch.Tensor:
    """Batch-statistics normalization of NHWC x: float32 mean and
    population variance over (N, H, W), the affine leaves, one rounding
    back to x's dtype.  No running statistics: an image's output depends
    on its batch, as in the reference.  With a process ``group`` whose
    ranks each hold an equal share of the batch's rows, the statistics
    cover every rank's rows (two differentiable all-reduces: the mean,
    then the squared deviations from it)."""
    x32 = x.float()
    if group is None:
        var, mu = torch.var_mean(x32, dim=(0, 1, 2), unbiased=False,
                                 keepdim=True)
    else:
        import torch.distributed as dist
        from torch.distributed.nn import functional as dist_fn

        n = x32[..., 0].numel() * dist.get_world_size(group)
        mu = dist_fn.all_reduce(torch.sum(x32, dim=(0, 1, 2), keepdim=True),
                                op=dist.ReduceOp.SUM, group=group) / n
        var = dist_fn.all_reduce(
            torch.sum(torch.square(x32 - mu), dim=(0, 1, 2), keepdim=True),
            op=dist.ReduceOp.SUM, group=group) / n
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * bn.scale.float() + bn.bias.float()).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C): the mean over the spatial dims."""
    return torch.mean(x, dim=(1, 2))


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*f, W*f, C), each pixel repeated f x f."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, factor, W, factor, C)
    return x.reshape(B, H * factor, W * factor, C)

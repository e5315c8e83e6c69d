"""EfficientNet (Tan & Le, arXiv:1905.11946), the ``efficientnet-b7``
config (width 2.0, depth 3.1: 55 MBConv blocks).

MBConv blocks (1x1 expansion, depthwise k x k, squeeze-excitation, 1x1
projection, residual where the shape allows) with SiLU and
batch-statistics normalization, NHWC throughout.  Attention-free, so
TimeRipple does not apply and no kernel of the port runs here: the
convolutions go to cuDNN through ``F.conv2d`` (``models.conv``), as the
reference leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import EffNetConfig
from repro_torch.models.common import Linear, Norm, remat_call
from repro_torch.models.conv import Conv, batchnorm, conv2d, global_avg_pool

# (expand_ratio, channels, layers, stride, kernel) — EfficientNet-B0 base
_B0_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]


def round_filters(c: int, width: float, divisor: int = 8) -> int:
    c = c * width
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(depth * r))


def effnet_stages(cfg: EffNetConfig) -> List[Tuple[int, ...]]:
    """Resolved (expand, c_in, c_out, repeats, stride, kernel) list."""
    stages = []
    c_prev = round_filters(32, cfg.width_mult)
    for expand, c, r, s, k in _B0_STAGES:
        c_out = round_filters(c, cfg.width_mult)
        stages.append((expand, c_prev, c_out, round_repeats(r, cfg.depth_mult),
                       s, k))
        c_prev = c_out
    return stages


class MBConv(nn.Module):
    """One block's leaves: ``expand`` and ``bn0`` only when the expansion
    ratio is not 1, then ``dw``, ``bn1``, ``se_reduce``, ``se_expand``,
    ``project`` and ``bn2``."""

    def __init__(self, c_in: int, c_out: int, expand: int, kernel: int,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c_mid = c_in * expand
        c_se = max(1, c_in // 4)
        if expand != 1:
            self.expand = Conv(1, c_in, c_mid, bias=False, **kw)
            self.bn0 = Norm(c_mid, **kw)
        else:
            self.expand = self.bn0 = None
        self.dw = Conv(kernel, c_mid, c_mid, bias=False, depthwise=True, **kw)
        self.bn1 = Norm(c_mid, **kw)
        self.se_reduce = Conv(1, c_mid, c_se, **kw)
        self.se_expand = Conv(1, c_se, c_mid, **kw)
        self.project = Conv(1, c_mid, c_out, bias=False, **kw)
        self.bn2 = Norm(c_out, **kw)

    def forward(self, x: torch.Tensor, stride: int,
                group=None) -> torch.Tensor:
        h = x
        if self.expand is not None:
            h = F.silu(batchnorm(self.bn0, conv2d(self.expand, h),
                                 group=group))
        h = F.silu(batchnorm(self.bn1, conv2d(self.dw, h, stride=stride),
                             group=group))
        # squeeze-excitation
        se = torch.mean(h, dim=(1, 2), keepdim=True)
        se = F.silu(conv2d(self.se_reduce, se))
        h = h * torch.sigmoid(conv2d(self.se_expand, se))
        h = batchnorm(self.bn2, conv2d(self.project, h), group=group)
        if stride == 1 and x.shape[-1] == h.shape[-1]:
            h = h + x
        return h


class EfficientNet(nn.Module):
    """EfficientNet parameters (leaf names of the JAX ``effnet_defs``;
    ``stages`` a list of stages, each a list of blocks) and the forward
    pass."""

    def __init__(self, cfg: EffNetConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        stem_c = round_filters(32, cfg.width_mult)
        head_c = round_filters(1280, cfg.width_mult)
        self.stem = Conv(3, cfg.in_channels, stem_c, bias=False, **kw)
        self.stem_bn = Norm(stem_c, **kw)
        stages = effnet_stages(cfg)
        self.stages = nn.ModuleList(
            nn.ModuleList(MBConv(c_in if i == 0 else c_out, c_out, expand, k,
                                 **kw) for i in range(repeats))
            for expand, c_in, c_out, repeats, _, k in stages)
        self.head = Conv(1, stages[-1][2], head_c, bias=False, **kw)
        self.head_bn = Norm(head_c, **kw)
        self.classifier = Linear(head_c, cfg.num_classes, **kw)

    def forward(self, images: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16,
                remat: bool = False, batch_group=None) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B, num_classes) in
        ``compute_dtype``.  ``remat`` recomputes each MBConv block's
        activations in the backward pass (the reference's
        ``jax.checkpoint`` of ``_mbconv``); the batch statistics are
        recomputed from the same inputs, so they are the same.  With a
        ``batch_group`` (ranks that split the batch) the batch statistics
        cover every rank's images, as the reference's over its sharded
        batch."""
        g = batch_group
        x = images.to(compute_dtype)
        x = F.silu(batchnorm(self.stem_bn, conv2d(self.stem, x, stride=2),
                             group=g))
        for (_, _, _, _, stride, _), blocks in zip(effnet_stages(self.cfg),
                                                   self.stages):
            for i, blk in enumerate(blocks):
                x = remat_call(remat, blk, x, stride if i == 0 else 1, g)
        x = F.silu(batchnorm(self.head_bn, conv2d(self.head, x), group=g))
        return self.classifier(global_avg_pool(x))


def effnet_apply(model: EfficientNet, images: torch.Tensor,
                 cfg: Optional[EffNetConfig] = None, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False, batch_group=None) -> torch.Tensor:
    """Functional form mirroring the JAX ``effnet_apply``."""
    if cfg is not None and cfg != model.cfg:
        raise ValueError("cfg does not match the model's config")
    return model(images, compute_dtype=compute_dtype, remat=remat,
                 batch_group=batch_group)

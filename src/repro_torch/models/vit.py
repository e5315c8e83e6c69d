"""ViT (Dosovitskiy et al., arXiv:2010.11929), the ``vit-l16`` config.

A pre-norm encoder with a cls token: patchify by reshape + matmul, fixed
2-D sin-cos position embeddings, affine LayerNorms, tanh-GELU MLPs.
TimeRipple is available in 2-D mode (x/y axes on the (1, h, w) patch
grid, the cls token outside it): one forward is step 0 of 2, so an
active config snaps at its fixed threshold (with ``i_min`` 0) or at θ 0
under the Eq. 4 ramp.  Off by default, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config.base import RippleConfig, ViTConfig
from repro_torch.models.attention import Attention, mha_attention
from repro_torch.models.common import (MLP, Linear, Norm, gelu_tanh,
                                       layernorm, mlp_bias_partial, param,
                                       patch_embed, remat_call,
                                       sincos_pos_embed_2d)

_RIPPLE_OFF = RippleConfig()


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = Norm(d, device, dtype)
        self.attn = Attention(d, cfg.num_heads, d // cfg.num_heads, device,
                              dtype, qk_norm=False)
        self.ln2 = Norm(d, device, dtype)
        self.mlp = MLP(d, cfg.d_ff, device, dtype)


class ViT(nn.Module):
    """ViT parameters (leaf names of the JAX ``vit_defs``, blocks as a
    per-layer list) and the forward pass, a plain loop over layers."""

    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.d_model, cfg.patch
        self.patch = Linear(p * p * cfg.in_channels, d, device, dtype)
        self.cls = param(1, 1, d, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(Block(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.ln_f = Norm(d, device, dtype)
        self.head = Linear(d, cfg.num_classes, device, dtype)

    def forward(self, images: torch.Tensor, *,
                ripple: RippleConfig = _RIPPLE_OFF,
                compute_dtype: torch.dtype = torch.bfloat16,
                remat: bool = False, ctx=None) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B, num_classes) in
        ``compute_dtype``.  ``remat`` recomputes each block's activations
        in the backward pass (the reference's ``jax.checkpoint`` of the
        scan body).  ``ctx`` (a ``ShardCtx``) with a ``tp`` computes on
        this rank's model pieces (see the module docstring)."""
        cfg = self.cfg
        tp = ctx.tp if ctx is not None else None
        rows = ctx is not None and ctx.attn_rows
        dt = compute_dtype
        B, H, W, _ = images.shape
        h, w = H // cfg.patch, W // cfg.patch
        x = patch_embed(self.patch.w, self.patch.b, images.to(dt), cfg.patch)
        pos = sincos_pos_embed_2d(h, w, cfg.d_model, device=x.device)
        x = x + pos.to(dt)[None]
        cls = self.cls.to(dt).expand(B, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1)
        hd = cfg.d_model // cfg.num_heads

        def body(x, blk):
            x = x + mha_attention(
                blk.attn, layernorm(x, scale=blk.ln1.scale, bias=blk.ln1.bias),
                n_heads=cfg.num_heads, head_dim=hd, grid=(1, h, w),
                ripple=ripple, step=0, total_steps=2, grid_slice=(1, h * w),
                tp=tp, attn_rows=rows)
            h_ = layernorm(x, scale=blk.ln2.scale, bias=blk.ln2.bias)
            if tp is None:
                return x + blk.mlp(h_)
            m = blk.mlp
            return x + mlp_bias_partial(m.wi, m.bi, m.wo, m.bo, h_, tp,
                                        cfg.d_ff, act=gelu_tanh)

        for blk in self.blocks:
            x = remat_call(remat, body, x, blk)
        x = layernorm(x, scale=self.ln_f.scale, bias=self.ln_f.bias)
        feat = x[:, 0] if cfg.pool == "cls" else torch.mean(x[:, 1:], dim=1)
        if tp is None:
            return self.head(feat)
        n = cfg.num_classes
        lo, hi = tp.span(n)
        feat = tp.enter(feat)
        logits = (torch.matmul(feat, tp.take(self.head.w, 1, n, lo, hi).to(dt))
                  + tp.take(self.head.b, 0, n, lo, hi).to(dt))
        return tp.join(logits, 1, n)


def vit_apply(model: ViT, images: torch.Tensor,
              cfg: Optional[ViTConfig] = None, *,
              ripple: RippleConfig = _RIPPLE_OFF,
              compute_dtype: torch.dtype = torch.bfloat16,
              remat: bool = False, ctx=None) -> torch.Tensor:
    """Functional form mirroring the JAX ``vit_apply``."""
    if cfg is not None and cfg != model.cfg:
        raise ValueError("cfg does not match the model's config")
    return model(images, ripple=ripple, compute_dtype=compute_dtype,
                 remat=remat, ctx=ctx)

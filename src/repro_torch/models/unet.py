"""SD1.5-style latent UNet (arXiv:2112.10752), the ``unet-sd15`` config,
mirroring the JAX package's ``repro/models/unet.py``.

4 levels (ch_mult 1-2-4-4), 2 res blocks per level, spatial transformer
blocks (self-attention + text cross-attention + GEGLU FF) at the
``attn_res`` downsample factors, a mid block with attention, skip
connections.  Activations are NHWC.

TimeRipple applies to the *self*-attention of the transformer blocks in
2-D mode on each level's (h, w) grid, through ``mha_attention`` and so
the fused Δ-check and ripple kernels at the level's head dim (40, 80 and
160 for unet-sd15); cross-attention (text K/V has no grid) is plain
matmul and float32 softmax, as in the reference, and is never snapped
(DESIGN.md §6).  Convolutions, GroupNorm and the upsampling are
``models.conv``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import RippleConfig, UNetConfig
from repro_torch.models import conv as conv_lib
from repro_torch.models.attention import Attention, mha_attention
from repro_torch.models.common import (Linear, gelu_tanh, param,
                                       remat_call, sincos_timestep_embed)
from repro_torch.models.conv import Conv, Norm

_RIPPLE_OFF = RippleConfig()


def _layernorm_sb(ln: Norm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with scale and bias over the last dim, eps 1e-5, in
    float32, cast back to x's dtype (the reference's ``_layernorm_sb``)."""
    x32 = x.float()
    var, mu = torch.var_mean(x32, dim=-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + 1e-5)
    return (out * ln.scale.float() + ln.bias.float()).to(x.dtype)


class ResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, t_dim: int, device=None,
                 dtype=None):
        super().__init__()
        self.norm1 = Norm(c_in, device, dtype)
        self.conv1 = Conv(3, c_in, c_out, device, dtype)
        self.temb = Linear(t_dim, c_out, device, dtype)
        self.norm2 = Norm(c_out, device, dtype)
        self.conv2 = Conv(3, c_out, c_out, device, dtype)
        self.skip = (Conv(1, c_in, c_out, device, dtype) if c_in != c_out
                     else None)

    def forward(self, x, temb):
        h = conv_lib.conv2d(self.conv1,
                            F.silu(conv_lib.groupnorm(self.norm1, x)))
        h = h + self.temb(F.silu(temb))[:, None, None, :]
        h = conv_lib.conv2d(self.conv2,
                            F.silu(conv_lib.groupnorm(self.norm2, h)))
        skip = conv_lib.conv2d(self.skip, x) if self.skip is not None else x
        return skip + h


class SpatialTransformer(nn.Module):
    """GroupNorm, 1x1 conv in; self-attention on the (1, H, W) grid,
    cross-attention to the text, GEGLU FF, each pre-LayerNorm and
    residual; 1x1 conv out, residual."""

    def __init__(self, c: int, n_heads: int, ctx_dim: int, device=None,
                 dtype=None):
        super().__init__()
        self.n_heads = n_heads
        self.norm = Norm(c, device, dtype)
        self.proj_in = Conv(1, c, c, device, dtype)
        self.ln1 = Norm(c, device, dtype)
        self.self_attn = Attention(c, n_heads, c // n_heads, device, dtype,
                                   qk_norm=False)
        self.ln2 = Norm(c, device, dtype)
        self.cross_q = param(c, c, device=device, dtype=dtype)
        self.cross_k = param(ctx_dim, c, device=device, dtype=dtype)
        self.cross_v = param(ctx_dim, c, device=device, dtype=dtype)
        self.cross_o = param(c, c, device=device, dtype=dtype)
        self.ln3 = Norm(c, device, dtype)
        self.ff1 = param(c, 8 * c, device=device, dtype=dtype)  # GEGLU
        self.ff2 = param(4 * c, c, device=device, dtype=dtype)
        self.proj_out = Conv(1, c, c, device, dtype)

    def forward(self, x, ctx_tokens, ripple: RippleConfig, step, total_steps):
        B, H, W, C = x.shape
        nh = self.n_heads
        hd = C // nh
        dt = x.dtype
        h = conv_lib.conv2d(self.proj_in, conv_lib.groupnorm(self.norm, x))
        tok = h.reshape(B, H * W, C)
        # Self-attention with the ripple hook on the (1, H, W) grid.
        tok = tok + mha_attention(
            self.self_attn, _layernorm_sb(self.ln1, tok), n_heads=nh,
            head_dim=hd, grid=(1, H, W), ripple=ripple, step=step,
            total_steps=total_steps)
        # Cross-attention to the text: plain matmul, float32 softmax.
        q = torch.matmul(_layernorm_sb(self.ln2, tok), self.cross_q.to(dt))
        k = torch.matmul(ctx_tokens, self.cross_k.to(dt))
        v = torch.matmul(ctx_tokens, self.cross_v.to(dt))
        q = q.reshape(B, -1, nh, hd).transpose(1, 2)
        k = k.reshape(B, -1, nh, hd).transpose(1, 2)
        v = v.reshape(B, -1, nh, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)).float() / (hd ** 0.5)
        attn = torch.softmax(logits, dim=-1).to(dt)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(B, -1, C)
        tok = tok + torch.matmul(o, self.cross_o.to(dt))
        # GEGLU feed-forward: the first half gated by the tanh GELU of the
        # second.
        hff = torch.matmul(_layernorm_sb(self.ln3, tok), self.ff1.to(dt))
        a_, b_ = torch.chunk(hff, 2, dim=-1)
        tok = tok + torch.matmul(a_ * gelu_tanh(b_), self.ff2.to(dt))
        return x + conv_lib.conv2d(self.proj_out, tok.reshape(B, H, W, C))


class Level(nn.Module):
    """One resolution: res blocks, a transformer after each where the
    level attends, and the ``down`` (stride-2) or ``up`` conv where the
    walk changes resolution (``resample`` names it)."""

    def __init__(self, res, attn, resample: Optional[str] = None,
                 c: int = 0, device=None, dtype=None):
        super().__init__()
        self.res = nn.ModuleList(res)
        self.attn = nn.ModuleList(attn)
        if resample is not None:
            setattr(self, resample, Conv(3, c, c, device, dtype))


class Mid(nn.Module):
    def __init__(self, c: int, t_dim: int, cfg: UNetConfig, device=None,
                 dtype=None):
        super().__init__()
        self.res1 = ResBlock(c, c, t_dim, device, dtype)
        self.attn = SpatialTransformer(c, cfg.num_heads, cfg.ctx_dim, device,
                                       dtype)
        self.res2 = ResBlock(c, c, t_dim, device, dtype)


def skip_channels(cfg: UNetConfig):
    """Channels of the skip stack, in push order (the reference's
    ``_skip_channels``)."""
    chans = [cfg.ch * m for m in cfg.ch_mult]
    skips = [cfg.ch]
    c_cur = cfg.ch
    for lvl, c_out in enumerate(chans):
        for _ in range(cfg.n_res_blocks):
            c_cur = c_out
            skips.append(c_cur)
        if lvl < len(chans) - 1:
            skips.append(c_cur)
    return skips


class UNet(nn.Module):
    """UNet parameters (leaf names of the JAX ``unet_defs``; ``down`` and
    ``up`` lists of levels, ``up`` from the coarsest level) and the
    forward walk with its skip stack."""

    def __init__(self, cfg: UNetConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.ch
        t_dim = 4 * ch
        chans = [ch * m for m in cfg.ch_mult]
        kw = dict(device=device, dtype=dtype)
        self.t_mlp1 = Linear(ch, t_dim, **kw)
        self.t_mlp2 = Linear(t_dim, t_dim, **kw)
        self.conv_in = Conv(3, cfg.in_channels, ch, **kw)

        def xformer(c):
            return SpatialTransformer(c, cfg.num_heads, cfg.ctx_dim, **kw)

        down, c_cur = [], ch
        for lvl, c_out in enumerate(chans):
            res, attn = [], []
            for _ in range(cfg.n_res_blocks):
                res.append(ResBlock(c_cur, c_out, t_dim, **kw))
                c_cur = c_out
                if 2 ** lvl in cfg.attn_res:
                    attn.append(xformer(c_out))
            down.append(Level(res, attn, "down" if lvl < len(chans) - 1
                              else None, c_out, **kw))
        self.down = nn.ModuleList(down)
        self.mid = Mid(c_cur, t_dim, cfg, **kw)
        skips = skip_channels(cfg)
        up = []
        for lvl in reversed(range(len(chans))):
            c_out = chans[lvl]
            res, attn = [], []
            for _ in range(cfg.n_res_blocks + 1):
                res.append(ResBlock(c_cur + skips.pop(), c_out, t_dim, **kw))
                c_cur = c_out
                if 2 ** lvl in cfg.attn_res:
                    attn.append(xformer(c_out))
            up.append(Level(res, attn, "up" if lvl > 0 else None, c_out,
                            **kw))
        self.up = nn.ModuleList(up)
        self.norm_out = Norm(ch, **kw)
        self.conv_out = Conv(3, ch, cfg.in_channels, **kw)

    def forward(self, latents: torch.Tensor, t: torch.Tensor,
                ctx_tokens: torch.Tensor, *,
                ripple: RippleConfig = _RIPPLE_OFF,
                step: Optional[int] = None, total_steps: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                remat: bool = False) -> torch.Tensor:
        """latents (B, H_lat, W_lat, C); t (B,) diffusion time;
        ctx_tokens (B, L, ctx_dim) text embeddings.  Returns the
        predicted noise (B, H_lat, W_lat, C) in ``compute_dtype``.
        ``remat`` recomputes each res block's and transformer block's
        activations in the backward pass (the reference's
        ``jax.checkpoint`` of ``_resblock`` and ``_xformer``)."""
        cfg = self.cfg
        dt = compute_dtype
        x = latents.to(dt)
        ctx_tokens = ctx_tokens.to(dt)
        temb = sincos_timestep_embed(t, cfg.ch).to(dt)
        temb = self.t_mlp2(F.silu(self.t_mlp1(temb)))
        attn_kw = dict(ripple=ripple, step=step, total_steps=total_steps)

        def res(rb, h):
            return remat_call(remat, rb, h, temb)

        def xformer(attn, h):
            return remat_call(remat, functools.partial(
                attn, ctx_tokens=ctx_tokens, **attn_kw), h)

        h = conv_lib.conv2d(self.conv_in, x)
        skips = [h]
        for level in self.down:
            for i, rb in enumerate(level.res):
                h = res(rb, h)
                if len(level.attn):
                    h = xformer(level.attn[i], h)
                skips.append(h)
            if hasattr(level, "down"):
                h = conv_lib.conv2d(level.down, h, stride=2)
                skips.append(h)

        h = res(self.mid.res1, h)
        h = xformer(self.mid.attn, h)
        h = res(self.mid.res2, h)

        for level in self.up:
            for i, rb in enumerate(level.res):
                h = res(rb, torch.cat([h, skips.pop()], dim=-1))
                if len(level.attn):
                    h = xformer(level.attn[i], h)
            if hasattr(level, "up"):
                h = conv_lib.conv2d(level.up,
                                    conv_lib.upsample_nearest(h, 2))

        h = F.silu(conv_lib.groupnorm(self.norm_out, h))
        return conv_lib.conv2d(self.conv_out, h)


def unet_apply(model: UNet, latents: torch.Tensor, t: torch.Tensor,
               ctx_tokens: torch.Tensor, cfg: Optional[UNetConfig] = None, *,
               ripple: RippleConfig = _RIPPLE_OFF, step: Optional[int] = None,
               total_steps: Optional[int] = None,
               compute_dtype: torch.dtype = torch.bfloat16,
               remat: bool = False) -> torch.Tensor:
    """Functional form mirroring the JAX ``unet_apply``."""
    if cfg is not None and cfg != model.cfg:
        raise ValueError("cfg does not match the model's config")
    return model(latents, t, ctx_tokens, ripple=ripple, step=step,
                 total_steps=total_steps, compute_dtype=compute_dtype,
                 remat=remat)

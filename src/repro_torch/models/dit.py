"""DiT — scalable image diffusion transformer (Peebles & Xie,
arXiv:2212.09748), the ``dit-xl2`` and ``dit-b2`` configs.

adaLN-zero conditioning on (timestep, class label); fixed 2-D sin-cos
position embeddings; patchify by reshape + matmul.  TimeRipple runs in
2-D mode (x/y axes on a (1, h, w) grid; no temporal axis, DESIGN.md §6),
driven by the sampler's denoising step.  Every LayerNorm-and-modulate
goes through the fused adaLN kernel (``kernels/adaln``), which rounds
once to the working type where the JAX model rounds after the norm and
after each modulation op (the same values in float32).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import DiTConfig, RippleConfig
from repro_torch.kernels.adaln.ops import adaln_modulate
from repro_torch.models.attention import Attention, mha_attention
from repro_torch.models.common import (Linear, gelu_tanh, mlp_bias, param,
                                       patch_embed, sincos_pos_embed_2d,
                                       sincos_timestep_embed, unpatchify)

_RIPPLE_OFF = RippleConfig()


class MLP(nn.Module):
    """Non-gated MLP with biases (leaves wi, bi, wo, bo) and tanh GELU."""

    def __init__(self, d: int, d_ff: int, device=None, dtype=None):
        super().__init__()
        self.wi = param(d, d_ff, device=device, dtype=dtype)
        self.bi = param(d_ff, device=device, dtype=dtype)
        self.wo = param(d_ff, d, device=device, dtype=dtype)
        self.bo = param(d, device=device, dtype=dtype)

    def forward(self, x):
        return mlp_bias(self.wi, self.bi, self.wo, self.bo, x, act=gelu_tanh)


class Block(nn.Module):
    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        d = cfg.d_model
        self.attn = Attention(d, cfg.num_heads, d // cfg.num_heads, device,
                              dtype, qk_norm=False)
        self.mlp = MLP(d, int(d * cfg.mlp_ratio), device, dtype)
        self.ada = Linear(d, 6 * d, device, dtype)


class DiT(nn.Module):
    """DiT parameters (leaf names of the JAX ``dit_defs``, blocks as a
    per-layer list) and the forward pass, a plain loop over layers."""

    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.d_model, cfg.patch
        out_ch = cfg.in_channels * (2 if cfg.learn_sigma else 1)
        self.patch = Linear(p * p * cfg.in_channels, d, device, dtype)
        self.t_mlp1 = Linear(256, d, device, dtype)
        self.t_mlp2 = Linear(d, d, device, dtype)
        # +1 row: the classifier-free-guidance null class.
        self.label_embed = param(cfg.num_classes + 1, d, device=device,
                                 dtype=dtype)
        self.blocks = nn.ModuleList(Block(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.final_ada = Linear(d, 2 * d, device, dtype)
        self.final = Linear(d, p * p * out_ch, device, dtype)

    def _conditioning(self, t, labels, dt):
        temb = sincos_timestep_embed(t, 256).to(dt)
        c = self.t_mlp2(F.silu(self.t_mlp1(temb)))
        c = c + self.label_embed.to(dt)[labels]
        return F.silu(c)  # (B, d)

    @torch.no_grad()
    def forward(self, latents: torch.Tensor, t: torch.Tensor,
                labels: torch.Tensor, *, ripple: RippleConfig = _RIPPLE_OFF,
                step: Optional[int] = None, total_steps: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """latents (B, H_lat, W_lat, C); t (B,) diffusion time; labels (B,)
        int class ids.  Returns the predicted noise (and sigma channels
        with ``learn_sigma``): (B, H_lat, W_lat, out_ch) in
        ``compute_dtype``."""
        cfg = self.cfg
        dt = compute_dtype
        B, H, W, C = latents.shape
        p = cfg.patch
        h, w = H // p, W // p
        grid = (1, h, w)

        x = patch_embed(self.patch.w, self.patch.b, latents.to(dt), p)
        pos = sincos_pos_embed_2d(h, w, cfg.d_model, device=x.device)
        x = x + pos.to(dt)[None]
        c = self._conditioning(t, labels, dt)
        hd = cfg.d_model // cfg.num_heads

        for blk in self.blocks:
            sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(blk.ada(c), 6, dim=-1)
            h_ = adaln_modulate(x, sh1, sc1)
            attn = mha_attention(
                blk.attn, h_, n_heads=cfg.num_heads, head_dim=hd, grid=grid,
                ripple=ripple, step=step, total_steps=total_steps)
            x = x + g1[:, None] * attn
            h_ = adaln_modulate(x, sh2, sc2)
            x = x + g2[:, None] * blk.mlp(h_)

        sh, sc = torch.chunk(self.final_ada(c), 2, dim=-1)
        x = adaln_modulate(x, sh, sc)
        x = self.final(x)
        out_ch = cfg.in_channels * (2 if cfg.learn_sigma else 1)
        return unpatchify(x, p, h, w, out_ch)


def dit_apply(model: DiT, latents: torch.Tensor, t: torch.Tensor,
              labels: torch.Tensor, cfg: Optional[DiTConfig] = None, *,
              ripple: RippleConfig = _RIPPLE_OFF, step: Optional[int] = None,
              total_steps: Optional[int] = None,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Functional form mirroring the JAX ``dit_apply``."""
    if cfg is not None and cfg != model.cfg:
        raise ValueError("cfg does not match the model's config")
    return model(latents, t, labels, ripple=ripple, step=step,
                 total_steps=total_steps, compute_dtype=compute_dtype)

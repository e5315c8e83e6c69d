"""The paper's native setting: a video diffusion transformer (vDiT).

3-D (t, x, y) latent token grid, factorized RoPE whose channel groups
carry temporal / x / y information (HunyuanVideo splits the 128-dim head
into 16/56/56), text tokens joined to the sequence ahead of the grid for
joint self-attention, adaLN conditioning on the timestep.  TimeRipple
runs in full 3-D mode: Δ-checks along all three axes under the Eq. 4
schedule, text tokens kept out of snapping by ``grid_slice``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import RippleConfig, VDiTConfig
from repro_torch.models.attention import Attention, mha_attention
from repro_torch.models.common import (Linear, layernorm, mlp, param,
                                       rope_3d_angles, sincos_timestep_embed)

_RIPPLE_OFF = RippleConfig()


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, device=None, dtype=None):
        super().__init__()
        self.wi_gate = param(d, d_ff, device=device, dtype=dtype)
        self.wi_up = param(d, d_ff, device=device, dtype=dtype)
        self.wo = param(d_ff, d, device=device, dtype=dtype)

    def forward(self, x):
        return mlp(self.wi_gate, self.wi_up, self.wo, x)


class Block(nn.Module):
    def __init__(self, cfg: VDiTConfig, device=None, dtype=None):
        super().__init__()
        d = cfg.d_model
        self.attn = Attention(d, cfg.num_heads, d // cfg.num_heads,
                              device, dtype)
        self.mlp = MLP(d, int(d * cfg.mlp_ratio), device, dtype)
        self.ada = Linear(d, 6 * d, device, dtype)


def patchify_3d(x, t_patch: int, patch: int):
    """(B, T, H, W, C) -> (B, T/tp * H/p * W/p, tp*p*p*C), (t,y,x) order."""
    B, T, H, W, C = x.shape
    tp, p = t_patch, patch
    x = x.reshape(B, T // tp, tp, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, (T // tp) * (H // p) * (W // p), tp * p * p * C)


def unpatchify_3d(x, t_patch: int, patch: int, tg: int, hg: int, wg: int,
                  out_ch: int):
    B = x.shape[0]
    tp, p = t_patch, patch
    x = x.reshape(B, tg, hg, wg, tp, p, p, out_ch)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, tg * tp, hg * p, wg * p, out_ch)


def _text_rope(L_txt: int, tg: int, axes_dim, device):
    """Text tokens sit at the grid origin with a pure temporal index
    ``tg + i`` beyond the video range, so they never alias a frame."""
    half_t = axes_dim[0] // 2
    pos = (tg + torch.arange(L_txt, device=device)).float()
    freqs = 1.0 / (10000.0 ** (torch.arange(half_t, dtype=torch.float32,
                                            device=device) / half_t))
    ang_t = pos[:, None] * freqs
    ang_rest = torch.zeros((L_txt, (axes_dim[1] + axes_dim[2]) // 2),
                           device=device)
    ang = torch.cat([ang_t, ang_rest], dim=-1)
    return torch.cos(ang), torch.sin(ang)


class VDiT(nn.Module):
    """vDiT parameters (leaf names of the JAX ``vdit_defs``, blocks as a
    per-layer list) and the forward pass, a plain loop over layers."""

    def __init__(self, cfg: VDiTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        in_dim = cfg.t_patch * cfg.patch * cfg.patch * cfg.in_channels
        self.patch = Linear(in_dim, d, device, dtype)
        self.txt_proj = Linear(cfg.txt_dim, d, device, dtype)
        self.t_mlp1 = Linear(256, d, device, dtype)
        self.t_mlp2 = Linear(d, d, device, dtype)
        self.blocks = nn.ModuleList(Block(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.final_ada = Linear(d, 2 * d, device, dtype)
        self.final = Linear(d, in_dim, device, dtype)

    @torch.no_grad()
    def forward(self, latents: torch.Tensor, t: torch.Tensor,
                txt: torch.Tensor, *, ripple: RippleConfig = _RIPPLE_OFF,
                step: Optional[int] = None, total_steps: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """latents (B, T, H, W, C); t (B,) diffusion time; txt (B, L, txt_dim)
        precomputed text embeddings.  Returns (B, T, H, W, C) in
        ``compute_dtype``."""
        cfg = self.cfg
        dt = compute_dtype
        B, T, H, W, C = latents.shape
        tg, hg, wg = T // cfg.t_patch, H // cfg.patch, W // cfg.patch
        grid = (tg, hg, wg)
        n_img = tg * hg * wg
        L_txt = txt.shape[1]
        dev = latents.device

        img = self.patch(patchify_3d(latents.to(dt), cfg.t_patch, cfg.patch))
        x = torch.cat([self.txt_proj(txt.to(dt)), img], dim=1)
        temb = sincos_timestep_embed(t, 256).to(dt)
        c = F.silu(self.t_mlp2(F.silu(self.t_mlp1(temb))))

        hd = cfg.d_model // cfg.num_heads
        cos_g, sin_g = rope_3d_angles(grid, cfg.axes_dim, device=dev)
        cos_t, sin_t = _text_rope(L_txt, tg, cfg.axes_dim, dev)
        rope_cos = torch.cat([cos_t, cos_g], dim=0)
        rope_sin = torch.cat([sin_t, sin_g], dim=0)

        for blk in self.blocks:
            sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(blk.ada(c), 6, dim=-1)
            h = layernorm(x) * (1 + sc1[:, None]) + sh1[:, None]
            attn = mha_attention(
                blk.attn, h, n_heads=cfg.num_heads, head_dim=hd, grid=grid,
                ripple=ripple, step=step, total_steps=total_steps,
                rope_cos=rope_cos, rope_sin=rope_sin,
                grid_slice=(L_txt, n_img))
            x = x + g1[:, None] * attn
            h = layernorm(x) * (1 + sc2[:, None]) + sh2[:, None]
            x = x + g2[:, None] * blk.mlp(h)

        sh, sc = torch.chunk(self.final_ada(c), 2, dim=-1)
        x = layernorm(x[:, L_txt:]) * (1 + sc[:, None]) + sh[:, None]
        x = self.final(x)
        return unpatchify_3d(x, cfg.t_patch, cfg.patch, tg, hg, wg, C)


def vdit_apply(model: VDiT, latents: torch.Tensor, t: torch.Tensor,
               txt: torch.Tensor, cfg: Optional[VDiTConfig] = None, *,
               ripple: RippleConfig = _RIPPLE_OFF, step: Optional[int] = None,
               total_steps: Optional[int] = None,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Functional form mirroring the JAX ``vdit_apply``."""
    if cfg is not None and cfg != model.cfg:
        raise ValueError("cfg does not match the model's config")
    return model(latents, t, txt, ripple=ripple, step=step,
                 total_steps=total_steps, compute_dtype=compute_dtype)

"""Shared layers: norms, linear, gated MLP, RoPE (factorized 3-D) and the
sinusoidal timestep embedding.  Functions on tensors; weights are kept
in the JAX package's (d_in, d_out) layout."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm in float32, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, eps: float = 1e-6):
    """Parameter-free LayerNorm in float32, cast back to x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def linear(w: torch.Tensor, b: Optional[torch.Tensor], x: torch.Tensor):
    """x @ w (+ b), weights cast to x's dtype."""
    out = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def mlp(wi_gate, wi_up, wo, x: torch.Tensor):
    """Gated (SwiGLU-style) MLP with SiLU."""
    dt = x.dtype
    g = torch.matmul(x, wi_gate.to(dt))
    u = torch.matmul(x, wi_up.to(dt))
    return torch.matmul(F.silu(g) * u, wo.to(dt))


def rope_freqs(dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def rope_3d_angles(grid: Tuple[int, int, int], axes_dim: Sequence[int],
                   theta: float = 10000.0, device=None):
    """Factorized (t, x, y) RoPE angles for a token grid (paper §3.1): the
    first ``axes_dim[0]`` channels rotate with the frame index, the next
    with x, the last with y.  Returns (cos, sin): (N, sum(axes_dim)/2)."""
    T, H, W = grid
    tt, yy, xx = torch.meshgrid(torch.arange(T, device=device),
                                torch.arange(H, device=device),
                                torch.arange(W, device=device), indexing="ij")
    coords = [tt.reshape(-1), xx.reshape(-1), yy.reshape(-1)]  # t, x, y
    parts = [pos[:, None].float() * rope_freqs(dim, theta, device)
             for dim, pos in zip(axes_dim, coords)]
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_precomputed(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor):
    """x: (..., N, H, hd) with hd == 2·cos.shape[-1]; split-half rotation
    in float32, cast back to x's dtype."""
    c = cos[..., None, :]
    s = sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def sincos_timestep_embed(t: torch.Tensor, dim: int,
                          max_period: float = 10000.0):
    """DDPM sinusoidal timestep embedding. t: (B,) -> (B, dim) float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device)
                      * float(np.float32(1.0) / np.float32(half)))
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb

"""Shared layers: norms, linear, gated and plain MLPs, RoPE (1-D and
factorized 3-D), patch embedding and the sinusoidal timestep and 2-D
position embeddings.  Functions on tensors, and the ``Linear``,
``Norm``, ``MLP`` and ``GatedMLP`` modules the models share; weights are
kept in the JAX package's (d_in, d_out) layout."""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm in float32, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, eps: float = 1e-6,
              scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None):
    """LayerNorm in float32, cast back to x's dtype; parameter-free, or
    with the affine ``scale`` and ``bias`` (a :class:`Norm`'s leaves)
    applied in float32 before the cast."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def linear(w: torch.Tensor, b: Optional[torch.Tensor], x: torch.Tensor):
    """x @ w (+ b), weights cast to x's dtype."""
    out = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def param(*shape, device=None, dtype=None) -> nn.Parameter:
    """An uninitialised parameter, created with ``requires_grad=False``:
    whether it trains is its caller's choice (the trainer's
    ``train_state_init`` turns it on; a served forward builds no
    graph)."""
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype),
                        requires_grad=False)


# The products whose outputs ``remat_policy="dots"`` keeps: a weight
# product (B, S, d) @ (d, F) folds to a 2-D ``mm``; a batched product
# (the attention's, the experts') is a ``bmm`` and is recomputed.
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_weight_products(ctx, op, *args, **kwargs):
    policy = torch.utils.checkpoint.CheckpointPolicy
    return (policy.MUST_SAVE if op in _WEIGHT_PRODUCTS
            else policy.PREFER_RECOMPUTE)


def _dots_contexts():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        _keep_weight_products)


# Set by ``block_hook``: ``hook(call, modules) -> call()``, around every
# call ``remat_call`` makes (the sharded trainer's per-block gathers).
_BLOCK_HOOK = contextvars.ContextVar("block_hook", default=None)


@contextlib.contextmanager
def block_hook(hook):
    """Within this scope ``remat_call(remat, fn, *args)`` returns
    ``hook(call, modules)``: ``call()`` runs the block as it would, and
    ``modules`` are the ``nn.Module`` s among ``fn`` (or a partial's
    function) and ``args``."""
    token = _BLOCK_HOOK.set(hook)
    try:
        yield
    finally:
        _BLOCK_HOOK.reset(token)


def remat_call(remat: bool, fn, *args, policy: str = "full"):
    """``fn(*args)``; with ``remat`` and grad mode on, its activations are
    recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
    ``policy="dots"`` keeps the outputs of the weight products and
    recomputes the rest, as the reference's
    ``dots_with_no_batch_dims_saveable``; ``"full"`` keeps nothing.
    Under :func:`block_hook` the hook runs the call."""
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")

    def call():
        if remat and torch.is_grad_enabled():
            ctx = {"context_fn": _dots_contexts} if policy == "dots" else {}
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False, **ctx)
        return fn(*args)

    hook = _BLOCK_HOOK.get()
    if hook is None:
        return call()
    return hook(call, [m for m in (fn, getattr(fn, "func", None), *args)
                       if isinstance(m, nn.Module)])


class Norm(nn.Module):
    """A norm's affine leaves ``scale`` and ``bias`` (c,): LayerNorm,
    GroupNorm and batch normalization."""

    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        self.scale = param(c, device=device, dtype=dtype)
        self.bias = param(c, device=device, dtype=dtype)


class Linear(nn.Module):
    """Weight ``w`` (d_in, d_out) and bias ``b`` — the JAX leaf names."""

    def __init__(self, d_in: int, d_out: int, device=None, dtype=None):
        super().__init__()
        self.w = param(d_in, d_out, device=device, dtype=dtype)
        self.b = param(d_out, device=device, dtype=dtype)

    def forward(self, x):
        return linear(self.w, self.b, x)


def mlp(wi_gate, wi_up, wo, x: torch.Tensor):
    """Gated (SwiGLU-style) MLP with SiLU."""
    dt = x.dtype
    g = torch.matmul(x, wi_gate.to(dt))
    u = torch.matmul(x, wi_up.to(dt))
    return torch.matmul(F.silu(g) * u, wo.to(dt))


def mlp_partial(wi_gate, wi_up, wo, x: torch.Tensor, tp, d_ff: int):
    """This rank's share of :func:`mlp` under tensor parallelism (``tp``,
    a ``distributed.tensor_parallel.TensorParallel``; ``x`` whole, from
    ``tp.enter``): its range of the ``d_ff`` hidden units, column-parallel
    in ``wi_gate`` / ``wi_up`` and row-parallel in ``wo``.  The ranks'
    shares sum to the MLP's output (``tp.leave``)."""
    dt = x.dtype
    lo, hi = tp.span(d_ff)
    g = torch.matmul(x, tp.take(wi_gate, 1, d_ff, lo, hi).to(dt))
    u = torch.matmul(x, tp.take(wi_up, 1, d_ff, lo, hi).to(dt))
    return torch.matmul(F.silu(g) * u, tp.take(wo, 0, d_ff, lo, hi).to(dt))


def mlp_bias(wi, bi, wo, bo, x: torch.Tensor, act=F.silu):
    """Non-gated MLP with biases: act(x @ wi + bi) @ wo + bo."""
    dt = x.dtype
    h = act(torch.matmul(x, wi.to(dt)) + bi.to(dt))
    return torch.matmul(h, wo.to(dt)) + bo.to(dt)


def mlp_bias_partial(wi, bi, wo, bo, x: torch.Tensor, tp, d_ff: int,
                     act=F.silu):
    """:func:`mlp_bias` as a tensor-parallel region over ``tp``'s group
    (``x`` whole on every rank, ``tp.enter``): the rank's range of the
    ``d_ff`` hidden units, column-parallel in ``wi`` and ``bi`` and
    row-parallel in ``wo``; the ranks' partial outputs summed
    (``tp.leave``), then ``bo``, replicated over ``model``, added once."""
    dt = x.dtype
    lo, hi = tp.span(d_ff)
    x = tp.enter(x)
    h = act(torch.matmul(x, tp.take(wi, 1, d_ff, lo, hi).to(dt))
            + tp.take(bi, 0, d_ff, lo, hi).to(dt))
    out = torch.matmul(h, tp.take(wo, 0, d_ff, lo, hi).to(dt))
    return tp.leave(out) + bo.to(dt)


class GatedMLP(nn.Module):
    """Gated MLP without biases (leaves wi_gate, wi_up, wo) and SiLU: the
    vDiT's and the LM family's."""

    def __init__(self, d: int, d_ff: int, device=None, dtype=None):
        super().__init__()
        self.wi_gate = param(d, d_ff, device=device, dtype=dtype)
        self.wi_up = param(d, d_ff, device=device, dtype=dtype)
        self.wo = param(d_ff, d, device=device, dtype=dtype)

    def forward(self, x):
        return mlp(self.wi_gate, self.wi_up, self.wo, x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """Non-gated MLP with biases (leaves wi, bi, wo, bo) and tanh GELU:
    the DiT's and the ViT's."""

    def __init__(self, d: int, d_ff: int, device=None, dtype=None):
        super().__init__()
        self.wi = param(d, d_ff, device=device, dtype=dtype)
        self.bi = param(d_ff, device=device, dtype=dtype)
        self.wo = param(d_ff, d, device=device, dtype=dtype)
        self.bo = param(d, device=device, dtype=dtype)

    def forward(self, x):
        return mlp_bias(self.wi, self.bi, self.wo, self.bo, x, act=gelu_tanh)


def rope_freqs(dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope_1d(x: torch.Tensor, positions: torch.Tensor,
                  theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int.  Split-half rotation
    in float32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    return apply_rope_precomputed(x, torch.cos(angles), torch.sin(angles))


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


def patch_embed(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                patch: int):
    """x: (B, H, W, C) -> (B, H/p * W/p, d), patches in (y, x) order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // patch, patch, W // patch, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(
        B, (H // patch) * (W // patch), patch * patch * C)
    return linear(w, b, x)


def unpatchify(x: torch.Tensor, patch: int, h: int, w: int, out_ch: int):
    """(B, h*w, p*p*C) -> (B, h*p, w*p, C)."""
    B = x.shape[0]
    x = x.reshape(B, h, w, patch, patch, out_ch)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h * patch, w * patch, out_ch)


def sincos_pos_embed_2d(h: int, w: int, dim: int, device=None):
    """Fixed 2-D sin-cos position embedding (DiT/ViT style): (h*w, dim)
    float32.  The division of the frequency exponents by their count is a
    multiplication by its float32 reciprocal, as XLA computes it under
    ``jit``."""
    def _1d(n, d):
        pos = torch.arange(n, dtype=torch.float32, device=device)
        exps = torch.arange(d // 2, dtype=torch.float32, device=device) \
            * float(np.float32(1.0) / np.float32(d // 2))
        omega = 1.0 / (10000.0 ** exps)
        out = pos[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    eh = _1d(h, dim // 2)  # (h, dim/2)
    ew = _1d(w, dim // 2)
    return torch.cat([eh.repeat_interleave(w, dim=0), ew.repeat(h, 1)],
                     dim=1)

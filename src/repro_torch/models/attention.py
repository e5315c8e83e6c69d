"""Bidirectional multi-head attention through the dispatch layer.

:func:`mha_attention` projects Q/K/V, applies qk-RMSNorm where the
weights have it (the vDiT; not the DiT), then the precomputed factorized
RoPE where given, and hands the (B, H, N, hd) operands to
``core.dispatch.attention_dispatch``, where an active
:class:`RippleConfig` routes Q/K through the reuse pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.config.base import RippleConfig
from repro_torch.core.dispatch import attention_dispatch
from repro_torch.models.common import apply_rope_precomputed, rmsnorm


class Scale(nn.Module):
    """A norm's elementwise scale (leaf name ``scale``)."""

    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype),
                                  requires_grad=False)


class Attention(nn.Module):
    """Self-attention weights: leaves wq, wk, wv, wo in (d_in, d_out)
    layout, and q_norm.scale, k_norm.scale with ``qk_norm`` (as the JAX
    ``attention_defs(qk_norm=...)``); without it both norms are None."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 device=None, dtype=None, qk_norm: bool = True):
        super().__init__()

        def w(a, b):
            return nn.Parameter(torch.empty(a, b, device=device, dtype=dtype),
                                requires_grad=False)

        inner = n_heads * head_dim
        self.wq, self.wk, self.wv = w(d_model, inner), w(d_model, inner), \
            w(d_model, inner)
        self.wo = w(inner, d_model)
        self.q_norm = Scale(head_dim, device, dtype) if qk_norm else None
        self.k_norm = Scale(head_dim, device, dtype) if qk_norm else None


def mha_attention(p: Attention, x: torch.Tensor, *, n_heads: int,
                  head_dim: int, grid: Tuple[int, int, int],
                  ripple: RippleConfig, step: Optional[int] = None,
                  total_steps: Optional[int] = None,
                  rope_cos: Optional[torch.Tensor] = None,
                  rope_sin: Optional[torch.Tensor] = None,
                  grid_slice: Optional[Tuple[int, int]] = None,
                  backend: Optional[str] = None,
                  encoder_out: Optional[torch.Tensor] = None,
                  cached_decision=None, return_decision: bool = False):
    """Bidirectional MHA through the dispatch layer. x: (B, N, d).

    ``cached_decision`` / ``return_decision`` thread the cross-step
    decision cache through to ``attention_dispatch``; with either set
    the layer returns ``(out, CachedDecision)``.  Self-attention on the
    grid only: with ``encoder_out`` (cross-attention, not ported) they
    raise, as in the JAX package."""
    want_cache = cached_decision is not None or return_decision
    if encoder_out is not None:
        if want_cache:
            raise ValueError("decision caching applies to grid "
                             "self-attention only, not cross-attention")
        raise NotImplementedError("cross-attention is not ported")
    dt = x.dtype
    B, N, _ = x.shape
    q = torch.matmul(x, p.wq.to(dt)).reshape(B, N, n_heads, head_dim)
    k = torch.matmul(x, p.wk.to(dt)).reshape(B, N, n_heads, head_dim)
    v = torch.matmul(x, p.wv.to(dt)).reshape(B, N, n_heads, head_dim)
    if p.q_norm is not None:
        q = rmsnorm(p.q_norm.scale, q)
        k = rmsnorm(p.k_norm.scale, k)
    if rope_cos is not None:
        q = apply_rope_precomputed(q, rope_cos, rope_sin)
        k = apply_rope_precomputed(k, rope_cos, rope_sin)
    # (B, H, N, hd) layout for the dispatch / kernel path
    q = q.transpose(1, 2).contiguous()
    k = k.transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()
    out = attention_dispatch(q, k, v, grid=grid, cfg=ripple, step=step,
                             total_steps=total_steps, grid_slice=grid_slice,
                             backend=backend, cached_decision=cached_decision,
                             return_decision=want_cache)
    new_cache = None
    if want_cache:
        out, new_cache = out
    out = out.transpose(1, 2).reshape(B, N, n_heads * head_dim)
    out = torch.matmul(out, p.wo.to(dt))
    return (out, new_cache) if want_cache else out

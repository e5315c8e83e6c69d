"""Attention layers.

* :func:`gqa_attention` — the LM family's decoder attention: grouped-query
  heads, optional qk-norm, 1-D RoPE, causal / sliding-window masks,
  prefill and decode against a KV cache.  Plain PyTorch: the JAX
  package computes it with einsums outside any Pallas kernel.
* :func:`mha_attention` — bidirectional attention through the dispatch
  layer: it projects Q/K/V, applies qk-RMSNorm where the weights have it
  (the vDiT; not the DiT), then the precomputed factorized RoPE where
  given, and hands the (B, H, N, hd) operands to
  ``core.dispatch.attention_dispatch``, where an active
  :class:`RippleConfig` routes Q/K through the reuse pipeline.  In
  training on a rank mesh with a ``model`` axis (``tp``) with ripple off,
  it is a tensor-parallel region (:func:`_mha_region`): the rank's heads,
  or where the heads do not divide the axis its query rows.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.config.base import RippleConfig
from repro_torch.core.dispatch import attention_dispatch
from repro_torch.models.common import (apply_rope_1d, apply_rope_precomputed,
                                       rmsnorm)

_NEG = -2.3819763e38  # the JAX package's mask constant (XLA's)


class Scale(nn.Module):
    """A norm's elementwise scale (leaf name ``scale``)."""

    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype),
                                  requires_grad=False)


class Attention(nn.Module):
    """Self-attention weights: leaves wq, wk, wv, wo in (d_in, d_out)
    layout, and q_norm.scale, k_norm.scale with ``qk_norm`` (as the JAX
    ``attention_defs(qk_norm=...)``); without it both norms are None.
    ``n_kv`` (default ``n_heads``) is the number of K/V heads."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 device=None, dtype=None, qk_norm: bool = True,
                 n_kv: Optional[int] = None):
        super().__init__()

        def w(a, b):
            return nn.Parameter(torch.empty(a, b, device=device, dtype=dtype),
                                requires_grad=False)

        inner = n_heads * head_dim
        kv = (n_kv or n_heads) * head_dim
        self.wq, self.wk, self.wv = w(d_model, inner), w(d_model, kv), \
            w(d_model, kv)
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
                  cached_decision=None, return_decision: bool = False,
                  tp=None, attn_rows: bool = False):
    """Bidirectional MHA through the dispatch layer. x: (B, N, d).

    ``cached_decision`` / ``return_decision`` thread the cross-step
    decision cache through to ``attention_dispatch``; with either set
    the layer returns ``(out, CachedDecision)``.  Self-attention on the
    grid only: with ``encoder_out`` (cross-attention, not ported) they
    raise, as in the JAX package.

    ``tp`` (a ``distributed.tensor_parallel.TensorParallel``) computes the
    layer as a region over the model group with ripple off, ``x`` whole
    on every rank and the whole output returned on every rank: by heads,
    or with ``attn_rows`` (the rules' ``attn_seq`` on ``model``) by query
    rows (:func:`_mha_region`)."""
    want_cache = cached_decision is not None or return_decision
    if encoder_out is not None:
        if want_cache:
            raise ValueError("decision caching applies to grid "
                             "self-attention only, not cross-attention")
        raise NotImplementedError("cross-attention is not ported")
    if tp is not None:
        if want_cache or ripple.active():
            raise NotImplementedError(
                "attention under a model axis runs with ripple off (the "
                "train steps); serving there is ROADMAP §1 item 5")
        return _mha_region(p, x, tp, n_heads=n_heads, head_dim=head_dim,
                           rope_cos=rope_cos, rope_sin=rope_sin, grid=grid,
                           ripple=ripple, attn_rows=attn_rows)
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


def _mha_region(p: Attention, x: torch.Tensor, tp, *, n_heads: int,
                head_dim: int, rope_cos, rope_sin, grid, ripple: RippleConfig,
                attn_rows: bool) -> torch.Tensor:
    """:func:`mha_attention` as a tensor-parallel region over ``tp``'s
    group, ``x`` whole on every rank (``tp.enter``):

    * by heads: the rank attends with its run of the heads (Q, K and V
      column-parallel in ``wq`` / ``wk`` / ``wv``, ``wo`` row-parallel on
      their rows; a piece that ends mid-head is all-gathered for the
      layer, ``tp.take``), and the ranks' partial outputs are summed
      (``tp.leave``);
    * by query rows (``attn_rows``, where the heads do not divide the
      group): the rank computes every head for its :meth:`span` of the N
      query rows against the whole K and V, with the weights taken whole,
      and the ranks' output rows are concatenated (``tp.join``).

    The q/k norm scales, replicated over ``model``, sum their gradients
    over the group (``tp.copy_to``)."""
    dt = x.dtype
    B, N, _ = x.shape
    inner = n_heads * head_dim
    x = tp.enter(x)
    h0, h1, r0, r1 = tp.attention_split(n_heads, N, attn_rows)
    c0, c1 = h0 * head_dim, h1 * head_dim
    H = h1 - h0

    def heads(y, rows):
        return y.reshape(B, rows, H, head_dim)

    q = heads(torch.matmul(x[:, r0:r1], tp.take(p.wq, 1, inner, c0, c1)
                           .to(dt)), r1 - r0)
    k = heads(torch.matmul(x, tp.take(p.wk, 1, inner, c0, c1).to(dt)), N)
    v = heads(torch.matmul(x, tp.take(p.wv, 1, inner, c0, c1).to(dt)), N)
    if p.q_norm is not None:
        q = rmsnorm(tp.copy_to(p.q_norm.scale), q)
        k = rmsnorm(tp.copy_to(p.k_norm.scale), k)
    if rope_cos is not None:
        q = apply_rope_precomputed(q, rope_cos[r0:r1], rope_sin[r0:r1])
        k = apply_rope_precomputed(k, rope_cos, rope_sin)
    out = attention_dispatch(q.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(), grid=grid,
                             cfg=ripple)
    out = out.transpose(1, 2).reshape(B, r1 - r0, H * head_dim)
    out = torch.matmul(out, tp.take(p.wo, 0, inner, c0, c1).to(dt))
    return tp.join(out, 1, N) if attn_rows else tp.leave(out)


# --- LM attention ------------------------------------------------------------

# Above this many logits per (batch·head) the core runs query chunks of
# _Q_CHUNK rows, so a 32k-token prefill never holds an (S, S) map.
_CHUNK_LOGIT_BUDGET = 4096 * 8192
_Q_CHUNK = 1024

# A mask: an additive float32 tensor (B|1, 1, S|1, S_kv), or a function
# of a query row range (r0, r1) giving those rows of one.
Mask = Union[torch.Tensor, Callable[[int, int], torch.Tensor]]


def _project(p: Attention, x: torch.Tensor, n_heads: int, n_kv: int,
             head_dim: int):
    dt = x.dtype
    B, S, _ = x.shape
    q = torch.matmul(x, p.wq.to(dt)).reshape(B, S, n_heads, head_dim)
    k = torch.matmul(x, p.wk.to(dt)).reshape(B, S, n_kv, head_dim)
    v = torch.matmul(x, p.wv.to(dt)).reshape(B, S, n_kv, head_dim)
    if p.q_norm is not None:
        q = rmsnorm(p.q_norm.scale, q)
        k = rmsnorm(p.k_norm.scale, k)
    return q, k, v


def causal_mask(S_q: int, S_kv: int, q_offset: int, sliding_window: int = 0,
                device=None) -> torch.Tensor:
    """Additive causal (+ sliding window) mask (1, 1, S_q, S_kv), float32.

    ``q_offset`` is the absolute position of query row 0; a
    ``sliding_window`` <= 0 disables the window."""
    qi = torch.arange(S_q, device=device)[:, None] + int(q_offset)
    kj = torch.arange(S_kv, device=device)[None, :]
    ok = kj <= qi
    if sliding_window > 0:
        ok = ok & (kj > qi - sliding_window)
    return _additive(ok)[None, None]


def valid_mask(S_q: int, S_kv: int, kv_len, device=None) -> torch.Tensor:
    """Mask (B|1, 1, 1, S_kv) of keys below ``kv_len`` (an int or a (B,)
    tensor), for attention against a partly filled cache.  An int is
    filled in on the device (a copy from the host would wait for the
    stream at every decode step)."""
    if isinstance(kv_len, torch.Tensor):
        kv_len = kv_len.to(device).reshape(-1)
    else:
        kv_len = torch.full((1,), int(kv_len), device=device)
    kj = torch.arange(S_kv, device=kv_len.device)[None, :]
    return _additive(kj < kv_len[:, None])[:, None, None]


def _additive(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, 0.0, _NEG).float()


def _rows(mask: Mask, r0: int, r1: int) -> torch.Tensor:
    """Query rows r0 .. r1 - 1 of a mask."""
    if isinstance(mask, torch.Tensor):
        return mask if mask.shape[2] == 1 else mask[:, :, r0:r1]
    return mask(r0, r1)


def _gqa_core_dense(q, k, v, mask: torch.Tensor):
    """q (B, S, Hq, hd), k (B, S_kv, Hkv, hd), v (B, S_kv, Hkv, dv), mask
    additive (B|1, 1, S|1, S_kv) -> (B, S, Hq, dv).

    The JAX package repeats K/V to Hq heads; here each K/V head serves its
    G = Hq / Hkv query heads in one product, rows in (query, group)
    order, with no copy of K or V.  The arithmetic is the reference's:
    products in the operands' dtype, float32 logits divided by sqrt(hd),
    the additive mask, the float32 softmax cast to V's dtype."""
    B, S, Hq, hd = q.shape
    S_kv, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    root = torch.full((), float(np.sqrt(np.float32(hd))), device=q.device)
    m = mask[:, 0, :, None, :]  # (B|1, S|1, 1, S_kv)
    out = torch.empty((B, S, Hkv, G, dv), dtype=v.dtype, device=q.device)
    for j in range(Hkv):
        qj = q[:, :, j * G:(j + 1) * G].reshape(B, S * G, hd)
        logits = torch.matmul(qj, k[:, :, j].transpose(1, 2))
        # mask + float32(logits) / sqrt(hd), each op rounded to float32 as
        # in the reference, in one pass.
        logits = torch.addcdiv(m, logits.view(B, S, G, S_kv), root)
        probs = torch.softmax(logits.view(B, S * G, S_kv), dim=-1).to(v.dtype)
        del logits
        out[:, :, j] = torch.matmul(probs, v[:, :, j]).view(B, S, G, dv)
        del probs
    return out.view(B, S, Hq, dv)


def _gqa_core(q, k, v, mask: Mask):
    """q (B, S, Hq, hd); k, v (B, S_kv, Hkv, hd).  Above the logit budget,
    with S a multiple of ``_Q_CHUNK``, query chunks of ``_Q_CHUNK`` rows
    run one after another (each row's values as in one pass)."""
    B, S, Hq, _ = q.shape
    S_kv = k.shape[1]
    if S * S_kv <= _CHUNK_LOGIT_BUDGET or S % _Q_CHUNK != 0:
        return _gqa_core_dense(q, k, v, _rows(mask, 0, S))
    out = torch.empty((B, S, Hq, v.shape[3]), dtype=v.dtype, device=q.device)
    for r0 in range(0, S, _Q_CHUNK):
        r1 = r0 + _Q_CHUNK
        out[:, r0:r1] = _gqa_core_dense(q[:, r0:r1], k, v, _rows(mask, r0, r1))
    return out


def _kv_for(q0: int, q1: int, G: int):
    """The K/V heads that query heads [q0, q1) attend with (G query heads a
    K/V head): (first, last + 1, and the index into them of each query
    head's, or None where each K/V head serves an equal run of the query
    heads in order, as ``_gqa_core_dense`` groups them)."""
    kv = [h // G for h in range(q0, q1)]
    k0, k1 = kv[0], kv[-1] + 1
    n, runs = q1 - q0, k1 - k0
    grouped = n % runs == 0 and kv == [k0 + i // (n // runs) for i in range(n)]
    return k0, k1, None if grouped else [h - k0 for h in kv]


def gqa_attention_partial(p: Attention, x: torch.Tensor, *, n_heads: int,
                          n_kv: int, head_dim: int, positions: torch.Tensor,
                          tp, rope_theta: float = 10000.0,
                          sliding_window: int = 0) -> torch.Tensor:
    """This rank's share of :func:`gqa_attention` (causal, no cache) under
    tensor parallelism (``tp``; ``x`` whole, from ``tp.enter``).

    Where the model group divides the query heads, the rank attends with
    its own run of them: Q column-parallel by whole heads, K and V for the
    K/V heads those query heads map to, ``wo`` row-parallel on their rows.
    Otherwise every rank computes every head and takes its even range of
    ``wo``'s rows.  A projection whose model piece is not the columns the
    rank needs (a piece that ends mid-head: qwen3-32b's kv at model 16) is
    all-gathered over the group for the block (``tp.take``).  The ranks'
    shares sum to the layer's output (``tp.leave``)."""
    B, S, _ = x.shape
    dt = x.dtype
    inner = n_heads * head_dim
    G = n_heads // n_kv
    if n_heads % tp.size == 0:
        q0, q1 = tp.span(n_heads)
        r0, r1 = q0 * head_dim, q1 * head_dim
    else:
        q0, q1 = 0, n_heads
        r0, r1 = tp.span(inner)
    k0, k1, rep = _kv_for(q0, q1, G)
    kv = n_kv * head_dim
    wq = tp.take(p.wq, 1, inner, q0 * head_dim, q1 * head_dim)
    wk = tp.take(p.wk, 1, kv, k0 * head_dim, k1 * head_dim)
    wv = tp.take(p.wv, 1, kv, k0 * head_dim, k1 * head_dim)
    q = torch.matmul(x, wq.to(dt)).reshape(B, S, q1 - q0, head_dim)
    k = torch.matmul(x, wk.to(dt)).reshape(B, S, k1 - k0, head_dim)
    v = torch.matmul(x, wv.to(dt)).reshape(B, S, k1 - k0, head_dim)
    if p.q_norm is not None:
        q = rmsnorm(tp.copy_to(p.q_norm.scale), q)
        k = rmsnorm(tp.copy_to(p.k_norm.scale), k)
    q = apply_rope_1d(q, positions, rope_theta)
    k = apply_rope_1d(k, positions, rope_theta)
    if rep is not None:
        k, v = k[:, :, rep], v[:, :, rep]
    out = _gqa_core(q, k, v, lambda a, b: causal_mask(
        b - a, S, a, sliding_window, x.device))
    out = out.reshape(B, S, (q1 - q0) * head_dim)
    if (r0, r1) != (q0 * head_dim, q1 * head_dim):
        out = out[..., r0:r1]
    return torch.matmul(out, tp.take(p.wo, 0, inner, r0, r1).to(dt))


def gqa_attention(p: Attention, x: torch.Tensor, *, n_heads: int, n_kv: int,
                  head_dim: int, positions: torch.Tensor,
                  rope_theta: float = 10000.0, sliding_window: int = 0,
                  cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  cache_index: Optional[int] = None):
    """LM attention. x: (B, S, d).

    * prefill without a cache (``cache is None``): causal self-attention;
      returns (out, (k, v));
    * with ``cache=(k_cache, v_cache)`` of shape (B, S_max, Hkv, hd) and
      ``cache_index`` the filled length: K/V of the S new positions are
      written into the cache in place at ``cache_index`` (the JAX
      package returns an updated copy), and the queries attend to the
      cache's first ``cache_index + S`` keys under the causal (and
      window) mask.  Returns (out, cache).

    The mask is built one query chunk at a time."""
    B, S, _ = x.shape
    q, k, v = _project(p, x, n_heads, n_kv, head_dim)
    q = apply_rope_1d(q, positions, rope_theta)
    k = apply_rope_1d(k, positions, rope_theta)
    dev = x.device
    if cache is None:
        out = _gqa_core(q, k, v, lambda r0, r1: causal_mask(
            r1 - r0, S, r0, sliding_window, dev))
        new_cache = (k, v)
    else:
        k_cache, v_cache = cache
        start = int(cache_index)
        S_kv = k_cache.shape[1]
        if not 0 <= start <= S_kv - S:
            raise ValueError(f"cache_index {start} + {S} new positions "
                             f"exceeds the cache's {S_kv}")
        k_cache[:, start:start + S] = k.to(k_cache.dtype)
        v_cache[:, start:start + S] = v.to(v_cache.dtype)
        valid = valid_mask(S, S_kv, start + S, dev)
        out = _gqa_core(q, k_cache, v_cache, lambda r0, r1: valid + causal_mask(
            r1 - r0, S_kv, start + r0, sliding_window, dev))
        new_cache = (k_cache, v_cache)
    out = out.reshape(B, S, n_heads * head_dim)
    return torch.matmul(out, p.wo.to(x.dtype)), new_cache

"""Decoder-only transformer LM family, as the JAX package's
``repro/models/transformer_lm.py``: one implementation for the four LM
archs through :class:`LMConfig`.

* qwen3-32b      — dense, GQA (64q/8kv), qk-norm
* gemma3-4b      — dense, GQA (8q/4kv), qk-norm, 5:1 local:global window
* qwen2-moe      — 60 routed experts (padded to 64) top-4 + 4 shared
* phi3.5-moe     — 16 routed experts top-2

The reference scans over layers stacked on a leading axis; here the
blocks are a per-layer list and the forward is a loop over them.  The
KV cache is (L, B, S_max, Hkv, hd) per K and V, written in place.
TimeRipple does not apply to 1-D text tokens.  Training: ``lm_loss``,
the next-token cross entropy (sequence-chunked above a cell budget),
with each block recomputed in the backward pass under ``remat``.  Every
entry point takes the reference's ``ctx`` (a ``ShardCtx``) and hands it
to the MoE, which runs expert parallelism on its mesh's ``model`` axis;
its activation constraints change no value (``distributed.sharding``).

Training on a rank mesh with a ``model`` axis (``ctx.tp``, a
``distributed.tensor_parallel.TensorParallel``) computes on this rank's
parameter pieces: each block's attention and MLP (or MoE) is a region
whose partial outputs are summed over the model group; the embedding is
vocab-parallel (tokens outside the rank's vocab range looked up as
zeros, the lookups summed over the group) and so is the head (the tied
embedding piece's transpose), with the cross entropy's max, sum of
exponentials and target logit combined over the group in float32.  With
``train.seq_parallel`` the residual stream between the regions holds
this rank's piece of the sequence (all-gathered into each region,
reduce-scattered out of it).  A vocab the group does not divide stays
whole on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import LMConfig
from repro_torch.distributed.sharding import NULL_CTX, ShardCtx
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (Attention, Scale, gqa_attention,
                                          gqa_attention_partial)
from repro_torch.models.common import (GatedMLP, mlp_partial, param,
                                       remat_call, rmsnorm)

Cache = Tuple[torch.Tensor, torch.Tensor]


class Block(nn.Module):
    """Leaves of the JAX ``_block_defs``: attn_norm, attn, mlp_norm, and
    ``moe`` (MoE configs) or ``mlp`` (dense ones)."""

    def __init__(self, cfg: LMConfig, device=None, dtype=None):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = Scale(d, device, dtype)
        self.attn = Attention(d, cfg.num_heads, cfg.resolved_head_dim, device,
                              dtype, qk_norm=cfg.qk_norm,
                              n_kv=cfg.num_kv_heads)
        self.mlp_norm = Scale(d, device, dtype)
        if cfg.moe is not None:
            self.moe = moe_lib.MoE(d, cfg.moe, device, dtype)
        else:
            self.mlp = GatedMLP(d, cfg.d_ff, device, dtype)


class TransformerLM(nn.Module):
    """The LM's parameters (leaf names of the JAX ``lm_defs``; blocks as a
    per-layer list): embed (V, d), blocks, final_norm, and lm_head (d, V)
    unless the embedding is tied."""

    def __init__(self, cfg: LMConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed = param(cfg.vocab_size, cfg.d_model, device=device,
                           dtype=dtype)
        self.blocks = nn.ModuleList(Block(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.final_norm = Scale(cfg.d_model, device, dtype)
        self.lm_head = (None if cfg.tie_embeddings else
                        param(cfg.d_model, cfg.vocab_size, device=device,
                              dtype=dtype))


def layer_windows(cfg: LMConfig) -> np.ndarray:
    """Per-layer sliding window (0 = global). gemma3: every (N+1)-th
    layer is global, the rest local."""
    if cfg.sliding_window <= 0 or cfg.local_global_pattern <= 0:
        return np.zeros((cfg.num_layers,), np.int32)
    pat = cfg.local_global_pattern
    win = np.full((cfg.num_layers,), cfg.sliding_window, np.int32)
    win[pat::pat + 1] = 0  # every (pat+1)-th layer global
    return win


def _block_tp(cfg: LMConfig, x, bp: Block, window: int, positions,
              ctx: ShardCtx):
    """A training block under tensor parallelism: ``x`` is the residual
    stream (whole, or this rank's sequence piece under sequence
    parallelism); each region's partial outputs summed over the model
    group."""
    tp = ctx.tp
    h = tp.enter(rmsnorm(tp.norm_scale(bp.attn_norm.scale), x))
    x = x + tp.leave(gqa_attention_partial(
        bp.attn, h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions, tp=tp,
        rope_theta=cfg.rope_theta, sliding_window=window))
    h = tp.enter(rmsnorm(tp.norm_scale(bp.mlp_norm.scale), x))
    if cfg.moe is not None:
        ffn_out, aux = moe_lib.moe_ffn(bp.moe, h, cfg.moe, ctx=ctx)
    else:
        ffn_out = mlp_partial(bp.mlp.wi_gate, bp.mlp.wi_up, bp.mlp.wo, h, tp,
                              cfg.d_ff)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + tp.leave(ffn_out), None, aux


def _block(cfg: LMConfig, x, bp: Block, window: int, positions,
           cache: Optional[Cache] = None, cache_index: Optional[int] = None,
           ctx: ShardCtx = NULL_CTX):
    if ctx.tp is not None:
        if cache is not None:
            raise NotImplementedError("LM serving under a model axis is not "
                                      "ported (ROADMAP §1 item 5)")
        return _block_tp(cfg, x, bp, window, positions, ctx)
    h = rmsnorm(bp.attn_norm.scale, x)
    attn_out, new_cache = gqa_attention(
        bp.attn, h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions,
        rope_theta=cfg.rope_theta, sliding_window=window, cache=cache,
        cache_index=cache_index)
    x = x + attn_out
    h = rmsnorm(bp.mlp_norm.scale, x)
    if cfg.moe is not None:
        ffn_out, aux = moe_lib.moe_ffn(bp.moe, h, cfg.moe, ctx=ctx)
    else:
        ffn_out = bp.mlp(h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ffn_out, new_cache, aux


def _head(model: TransformerLM) -> torch.Tensor:
    """The (d, V) output projection: the embedding's transpose if tied
    (under tensor parallelism this rank's (d, V/M) piece of it, where the
    group divides the vocab)."""
    return model.embed.T if model.cfg.tie_embeddings else model.lm_head


def _vocab_parallel(cfg: LMConfig, tp) -> bool:
    """Are the embedding and head split over the model group (the rule
    tables' ``vocab`` on ``model``, where it divides)?"""
    return cfg.vocab_size % tp.size == 0


def _embed_tp(model: TransformerLM, tokens: torch.Tensor, tp, dt):
    """The embedding under tensor parallelism: the residual stream
    (whole, or this rank's sequence piece).  Vocab-parallel: each rank
    looks up the tokens of its vocab range (zeros for the others) and the
    lookups are summed over the group."""
    cfg = model.cfg
    if not _vocab_parallel(cfg, tp):
        x = F.embedding(tokens, model.embed).to(dt)
        return tp.split(x, 1) if tp.seq_parallel else x
    lo, hi = tp.span(cfg.vocab_size)
    mine = (tokens >= lo) & (tokens < hi)
    x = F.embedding(torch.where(mine, tokens - lo, 0), model.embed).to(dt)
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=dt,
                                                    device=x.device))
    return tp.leave(x)


def lm_apply(model: TransformerLM, tokens: torch.Tensor,
             cfg: Optional[LMConfig] = None, *, ctx: ShardCtx = NULL_CTX,
             compute_dtype: torch.dtype = torch.bfloat16,
             remat: bool = False, remat_policy: str = "full",
             cache: Optional[Cache] = None, cache_index: Optional[int] = None,
             logits_mode: str = "all"):
    """Forward pass. tokens: (B, S) integer, on the model's device.

    With ``cache=(k, v)`` of shape (L, B, S_max, Hkv, hd) this is a
    prefill or decode step writing the cache in place at ``cache_index``.
    ``logits_mode``: 'all' (B, S, V), 'last' (B, 1, V), or 'none' (the
    final-normed hidden states).  ``remat`` recomputes each block in the
    backward pass (without a cache, under grad mode), keeping nothing
    (``remat_policy="full"``) or the weight products' outputs
    (``"dots"``).  Returns (logits-or-hidden, cache, aux_loss)."""
    if cfg is not None and cfg != model.cfg:
        raise ValueError("cfg does not match the model's config")
    if logits_mode not in ("all", "last", "none"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    cfg = model.cfg
    dt = compute_dtype
    B, S = tokens.shape
    tp = ctx.tp
    if tp is not None and logits_mode != "none":
        raise NotImplementedError(
            "under a model axis lm_apply returns the hidden states only "
            "(logits_mode='none'; lm_loss takes the vocab-parallel head); "
            "LM serving under a model axis is not ported "
            "(ROADMAP §1 item 5)")
    if tp is None:
        x = F.embedding(tokens, model.embed).to(dt)
    else:
        x = _embed_tp(model, tokens, tp, dt)
    offset = 0 if cache is None else int(cache_index)
    positions = offset + torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, blk, window):
        x, _, a = _block(cfg, x, blk, window, positions, ctx=ctx)
        return x, a

    for i, (blk, window) in enumerate(zip(model.blocks, layer_windows(cfg))):
        if cache is None:
            x, a = remat_call(remat, body, x, blk, int(window),
                              policy=remat_policy)
        else:
            x, _, a = _block(cfg, x, blk, int(window), positions,
                             (cache[0][i], cache[1][i]), cache_index, ctx)
        aux = aux + a
    scale = model.final_norm.scale
    x = rmsnorm(scale if tp is None else tp.norm_scale(scale), x)
    if logits_mode == "none":
        return x, cache, aux
    if logits_mode == "last":
        x = x[:, -1:]
    return torch.matmul(x, _head(model).to(dt)), cache, aux


# Sequence-chunked cross entropy: above this many (token x vocab) cells
# the logits never exist for the whole sequence at once; each chunk's are
# recomputed in the backward pass.  Read at call time.
_CE_CELL_BUDGET = 2048 * 65536
_CE_CHUNK = 512


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed cross entropy in float32: logsumexp minus the gold logit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.sum(logz - gold)


def _chunk_ce(h: torch.Tensor, targets: torch.Tensor,
              head: torch.Tensor) -> torch.Tensor:
    """One sequence chunk's summed cross entropy: its logits h @ head."""
    return _ce(torch.matmul(h, head), targets)


def _ce_tp(logits: torch.Tensor, targets: torch.Tensor, lo: int,
           tp) -> torch.Tensor:
    """:func:`_ce` of vocab-parallel logits (this rank's vocab slice from
    ``lo``): the max, the sum of exponentials and the target logit
    combined over the model group, in float32."""
    logits = logits.float()
    top = tp.reduce_max(torch.amax(logits, dim=-1))
    total = tp.reduce_from(torch.sum(torch.exp(logits - top[..., None]), -1))
    logz = torch.log(total) + top
    n = logits.shape[-1]
    mine = (targets >= lo) & (targets < lo + n)
    local = torch.gather(logits, -1, torch.where(mine, targets - lo,
                                                 0)[..., None])[..., 0]
    gold = tp.reduce_from(torch.where(mine, local, torch.zeros_like(local)))
    return torch.sum(logz - gold)


def _chunk_ce_tp(h: torch.Tensor, targets: torch.Tensor, head: torch.Tensor,
                 lo: int, tp) -> torch.Tensor:
    return _ce_tp(torch.matmul(h, head), targets, lo, tp)


def _nll_tp(model: TransformerLM, hidden: torch.Tensor,
            targets: torch.Tensor, tp, dt) -> torch.Tensor:
    """The summed cross entropy of the final-normed ``hidden`` under
    tensor parallelism: vocab-parallel on the whole sequence, or, with a
    vocab the group does not divide, on whole logits (this rank's
    sequence piece under sequence parallelism, summed over the group).
    Chunked as :func:`lm_loss` chunks."""
    cfg = model.cfg
    head = _head(model)
    vocab_par = _vocab_parallel(cfg, tp)
    if vocab_par:
        h = tp.enter(hidden)
        lo, _ = tp.span(cfg.vocab_size)
        fn, extra = _chunk_ce_tp, (head.to(dt), lo, tp)
    else:
        h = hidden
        if tp.seq_parallel:
            head = tp.copy_to(head)
            targets = tp.split(targets, 1)
        fn, extra = _chunk_ce, (head.to(dt),)
    S = h.shape[1]
    if S * cfg.vocab_size <= _CE_CELL_BUDGET or S % _CE_CHUNK != 0:
        total = fn(h, targets, *extra)
    else:
        c = _CE_CHUNK
        total = torch.sum(torch.stack([
            remat_call(True, fn, h[:, i:i + c], targets[:, i:i + c], *extra)
            for i in range(0, S, c)]))
    if not vocab_par and tp.seq_parallel:
        total = tp.reduce_from(total)
    return total


def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            targets: torch.Tensor, cfg: Optional[LMConfig] = None, *,
            ctx: ShardCtx = NULL_CTX,
            compute_dtype: torch.dtype = torch.bfloat16, remat: bool = True,
            remat_policy: str = "full"):
    """Next-token cross entropy. tokens/targets: (B, S) integer.  The
    summed float32 cross entropy over B·S plus the router's aux loss;
    returns (loss, {"nll", "aux"}).  Above ``_CE_CELL_BUDGET`` (S · V)
    with S a multiple of ``_CE_CHUNK``, the head product and the cross
    entropy run one ``_CE_CHUNK``-token chunk at a time, each recomputed
    in the backward pass."""
    B, S = tokens.shape
    targets = targets.long()
    kw = dict(ctx=ctx, compute_dtype=compute_dtype, remat=remat,
              remat_policy=remat_policy)
    if ctx.tp is not None:
        hidden, _, aux = lm_apply(model, tokens, cfg, logits_mode="none",
                                  **kw)
        nll = _nll_tp(model, hidden, targets, ctx.tp, compute_dtype) / (B * S)
    elif S * model.cfg.vocab_size <= _CE_CELL_BUDGET or S % _CE_CHUNK != 0:
        logits, _, aux = lm_apply(model, tokens, cfg, **kw)
        nll = _ce(logits, targets) / (B * S)
    else:
        hidden, _, aux = lm_apply(model, tokens, cfg, logits_mode="none",
                                  **kw)
        head = _head(model).to(compute_dtype)
        c = _CE_CHUNK
        totals = [remat_call(True, _chunk_ce, hidden[:, i:i + c],
                             targets[:, i:i + c], head)
                  for i in range(0, S, c)]
        nll = torch.sum(torch.stack(totals)) / (B * S)
    return nll + aux, {"nll": nll, "aux": aux}


# --- KV cache / serving ------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
    """Zero K and V caches, each (L, batch, max_len, Hkv, hd)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


@torch.no_grad()
def lm_prefill(model: TransformerLM, tokens: torch.Tensor, cfg: LMConfig,
               max_len: int, *, ctx: ShardCtx = NULL_CTX,
               compute_dtype: torch.dtype = torch.bfloat16):
    """Prefill: run the prompt into a fresh cache of ``max_len``
    positions; returns (last logits (B, 1, V), cache at length S).
    Serving: runs under ``no_grad``."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len={max_len}")
    cache = init_cache(cfg, B, max_len, compute_dtype, tokens.device)
    logits, cache, _ = lm_apply(model, tokens, cfg, ctx=ctx,
                                compute_dtype=compute_dtype, cache=cache,
                                cache_index=0, logits_mode="last")
    return logits, cache


@torch.no_grad()
def lm_decode_step(model: TransformerLM, token: torch.Tensor, cache: Cache,
                   cache_index: int, cfg: LMConfig, *,
                   ctx: ShardCtx = NULL_CTX,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """One decode step. token: (B, 1); returns (logits (B, 1, V), cache),
    the cache written in place at ``cache_index``.  Serving: runs under
    ``no_grad``."""
    logits, cache, _ = lm_apply(model, token, cfg, ctx=ctx,
                                compute_dtype=compute_dtype, cache=cache,
                                cache_index=cache_index, logits_mode="last")
    return logits, cache

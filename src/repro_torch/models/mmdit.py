"""Flux-style MMDiT: double-stream joint blocks + single-stream blocks
(the ``flux-dev`` config: 19 double and 38 single blocks, d_model 3072,
24 heads of 128, factorized RoPE with axes_dim (16, 56, 56)).

Double blocks keep separate image and text streams (each its own adaLN
modulation, QKV, norms, output projection and MLP) and attend jointly
over the text-first concatenation; single blocks run the fused stream
with one ``lin1`` giving Q/K/V and the MLP input and one ``lin2``
taking both back.  The timestep embedding takes the rectified-flow t
in [0, 1] as it is.  TimeRipple applies to the image-grid tokens of
the joint attention (2-D mode, x/y axes on a (1, h, w) grid); text
tokens are never snapped (``grid_slice``).  LayerNorm-and-modulate is
inline, as in the JAX ``mmdit_apply``, so the adaLN kernel is not on
this path.

Under a rank mesh's ``model`` axis (``ctx.tp``, training with ripple
off) every block is tensor-parallel (``distributed.tensor_parallel``).
The rule tables put ``heads`` on a *fused* axis: the double streams'
``wqkv`` (d, 3d) and the single blocks' ``lin1`` (d, 3d + F), ``lin1_b``
and ``lin2`` (d + F, d) are split in contiguous pieces, which are
neither a rank's heads' q / k / v columns nor a clean split between
attention and MLP.  So a block takes those weights whole (all-gathered,
their gradients reduce-scattered back) and the rank computes with its
heads' q, k and v columns (or, where the heads do not divide the axis,
every head for its query rows of the joint sequence) and, in a single
block, its range of the MLP's hidden units; the double streams' MLPs are
plain regions on their ``mlp`` pieces.  The modulations, replicated over
``model``, run whole on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import MMDiTConfig, RippleConfig
from repro_torch.core.dispatch import attention_dispatch
from repro_torch.models.attention import Scale
from repro_torch.models.common import (Linear, apply_rope_precomputed,
                                       gelu_tanh, layernorm, linear,
                                       mlp_bias_partial, param, patch_embed,
                                       remat_call, rmsnorm, rope_3d_angles,
                                       sincos_timestep_embed, unpatchify)

_RIPPLE_OFF = RippleConfig()


class Stream(nn.Module):
    """One stream of a double block (leaves of the JAX ``_stream_defs``)."""

    def __init__(self, d: int, n_heads: int, mlp_ratio: float, device=None,
                 dtype=None):
        super().__init__()
        ff = int(d * mlp_ratio)
        self.mod = Linear(d, 6 * d, device, dtype)
        self.wqkv = param(d, 3 * d, device=device, dtype=dtype)
        self.wo = param(d, d, device=device, dtype=dtype)
        self.mlp_in = param(d, ff, device=device, dtype=dtype)
        self.mlp_in_b = param(ff, device=device, dtype=dtype)
        self.mlp_out = param(ff, d, device=device, dtype=dtype)
        self.mlp_out_b = param(d, device=device, dtype=dtype)
        self.q_norm = Scale(d // n_heads, device, dtype)
        self.k_norm = Scale(d // n_heads, device, dtype)


class Single(nn.Module):
    """A single-stream block (leaves of the JAX ``_single_defs``)."""

    def __init__(self, d: int, n_heads: int, mlp_ratio: float, device=None,
                 dtype=None):
        super().__init__()
        ff = int(d * mlp_ratio)
        self.mod = Linear(d, 3 * d, device, dtype)
        self.lin1 = param(d, 3 * d + ff, device=device, dtype=dtype)
        self.lin1_b = param(3 * d + ff, device=device, dtype=dtype)
        self.lin2 = param(d + ff, d, device=device, dtype=dtype)
        self.lin2_b = param(d, device=device, dtype=dtype)
        self.q_norm = Scale(d // n_heads, device, dtype)
        self.k_norm = Scale(d // n_heads, device, dtype)


class Double(nn.Module):
    """The double blocks: per-layer image and text streams."""

    def __init__(self, cfg: MMDiTConfig, device=None, dtype=None):
        super().__init__()
        args = (cfg.d_model, cfg.num_heads, cfg.mlp_ratio, device, dtype)
        self.img = nn.ModuleList(Stream(*args)
                                 for _ in range(cfg.n_double_blocks))
        self.txt = nn.ModuleList(Stream(*args)
                                 for _ in range(cfg.n_double_blocks))


def _modulate(x, shift, scale):
    """Parameter-free LayerNorm, then ``* (1 + scale) + shift``."""
    return layernorm(x) * (1 + scale[:, None]) + shift[:, None]


def _heads(x, n_heads: int):
    B, N, d = x.shape
    return x.reshape(B, N, n_heads, d // n_heads)


def joint_rope(L: int, grid, axes_dim, device):
    """(cos, sin) over the joint sequence: text rows at positions 1..L on
    the first ``axes_dim[0] // 2`` frequencies (cos 1, sin 0 on the
    rest), then the grid's factorized (t, x, y) rows."""
    half = axes_dim[0] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=device) / half))
    ang_t = (1 + torch.arange(L, device=device))[:, None].float() * freqs
    rest = torch.zeros((L, (axes_dim[1] + axes_dim[2]) // 2), device=device)
    ang = torch.cat([ang_t, rest], dim=-1)
    cos_g, sin_g = rope_3d_angles(grid, axes_dim, device=device)
    return (torch.cat([torch.cos(ang), cos_g], dim=0),
            torch.cat([torch.sin(ang), sin_g], dim=0))


def joint_attention(q, k, v, rope_cos, rope_sin, *, grid, grid_slice,
                    ripple: RippleConfig, step, total_steps, rows=None):
    """q/k/v: (B, N, H, hd), q and k already normed; RoPE on q and k, one
    dispatch call on the (B, H, N, hd) views (the fused Δ-check reads q
    and k in place; the ripple kernel takes a contiguous v); returns
    (B, N, H * hd).  With ``rows`` (r0, r1) q holds only those rows of
    the sequence (a query-row region), and so does the output."""
    r0, r1 = rows or (0, q.shape[1])
    q = apply_rope_precomputed(q, rope_cos[r0:r1], rope_sin[r0:r1])
    k = apply_rope_precomputed(k, rope_cos, rope_sin)
    out = attention_dispatch(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2).contiguous(), grid=grid,
                             cfg=ripple, step=step, total_steps=total_steps,
                             grid_slice=grid_slice)
    B, H, N, hd = out.shape
    return out.transpose(1, 2).reshape(B, N, H * hd)


class MMDiT(nn.Module):
    """MMDiT parameters (leaf names of the JAX ``mmdit_defs``; the
    layer-stacked ``double.img``, ``double.txt`` and ``single`` trees as
    per-layer lists) and the forward pass, plain loops over blocks.  The
    ``double`` subtree lives in ``double_blocks`` (``nn.Module.double``
    is a method); ``leaf_aliases`` maps the leaf path's name to it."""

    leaf_aliases = {"double": "double_blocks"}

    def __init__(self, cfg: MMDiTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.d_model, cfg.patch
        in_dim = p * p * cfg.in_channels
        self.img_in = Linear(in_dim, d, device, dtype)
        self.txt_in = Linear(cfg.txt_dim, d, device, dtype)
        self.t_mlp1 = Linear(256, d, device, dtype)
        self.t_mlp2 = Linear(d, d, device, dtype)
        self.vec_in = Linear(768, d, device, dtype)
        self.double_blocks = Double(cfg, device, dtype)
        self.single = nn.ModuleList(
            Single(d, cfg.num_heads, cfg.mlp_ratio, device, dtype)
            for _ in range(cfg.n_single_blocks))
        self.final_mod = Linear(d, 2 * d, device, dtype)
        self.final = Linear(d, in_dim, device, dtype)

    def _qkv(self, blk: Stream, h):
        dt = h.dtype
        q, k, v = torch.chunk(torch.matmul(h, blk.wqkv.to(dt)), 3, dim=-1)
        H = self.cfg.num_heads
        return (rmsnorm(blk.q_norm.scale, _heads(q, H)),
                rmsnorm(blk.k_norm.scale, _heads(k, H)), _heads(v, H))

    def _post(self, blk: Stream, x, proj, mods, tp=None):
        """The stream's residual with its projected attention ``proj``,
        then its MLP (a region over the ``mlp`` pieces under ``tp``)."""
        g, sh2, sc2, g2 = mods
        x = x + g[:, None] * proj
        h = _modulate(x, sh2, sc2)
        if tp is None:
            m = gelu_tanh(linear(blk.mlp_in, blk.mlp_in_b, h))
            return x + g2[:, None] * linear(blk.mlp_out, blk.mlp_out_b, m)
        ff = int(self.cfg.d_model * self.cfg.mlp_ratio)
        return x + g2[:, None] * mlp_bias_partial(
            blk.mlp_in, blk.mlp_in_b, blk.mlp_out, blk.mlp_out_b, h, tp, ff,
            act=gelu_tanh)

    def _double_tp(self, txt_x, img, ti: Stream, im: Stream, sc, rope,
                   attn_kw, tp, rows: bool):
        """A double block under ``tp`` (see the module docstring); the
        attention's projected output combined over the group once for
        both streams (summed by heads, joined by rows)."""
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.d_model // cfg.num_heads
        L, dt = txt_x.shape[1], txt_x.dtype
        n = L + img.shape[1]
        h0, h1, r0, r1 = tp.attention_split(cfg.num_heads, n, rows)
        c0, c1 = h0 * hd, h1 * hd
        # The joint rows [r0, r1) as text rows and image rows.
        spans = ((min(r0, L), min(r1, L)), (max(r0, L) - L, max(r1, L) - L))
        t_sh, t_sc, *t_mods = torch.chunk(ti.mod(sc), 6, dim=-1)
        i_sh, i_sc, *i_mods = torch.chunk(im.mod(sc), 6, dim=-1)
        qs, ks, vs = [], [], []
        for blk, x, (a, b) in ((ti, _modulate(txt_x, t_sh, t_sc), spans[0]),
                               (im, _modulate(img, i_sh, i_sc), spans[1])):
            x = tp.enter(x)
            w = tp.take(blk.wqkv, 1, 3 * d, 0, 3 * d).to(dt)
            q, k, v = (w[:, o + c0:o + c1] for o in (0, d, 2 * d))
            qs.append(rmsnorm(tp.copy_to(blk.q_norm.scale),
                              _heads(torch.matmul(x[:, a:b], q), h1 - h0)))
            ks.append(rmsnorm(tp.copy_to(blk.k_norm.scale),
                              _heads(torch.matmul(x, k), h1 - h0)))
            vs.append(_heads(torch.matmul(x, v), h1 - h0))
        out = joint_attention(torch.cat(qs, 1), torch.cat(ks, 1),
                              torch.cat(vs, 1), *rope, rows=(r0, r1),
                              **attn_kw)
        t_rows = spans[0][1] - spans[0][0]
        proj = torch.cat([torch.matmul(part, tp.take(blk.wo, 0, d, c0, c1)
                                       .to(dt))
                          for blk, part in ((ti, out[:, :t_rows]),
                                            (im, out[:, t_rows:]))], 1)
        proj = tp.join(proj, 1, n) if rows else tp.leave(proj)
        return (self._post(ti, txt_x, proj[:, :L], t_mods, tp),
                self._post(im, img, proj[:, L:], i_mods, tp))

    def _single_tp(self, x, blk: Single, sc, rope, attn_kw, tp, rows: bool):
        """A single block under ``tp`` (see the module docstring): by heads
        the rank's heads and its range of the MLP's hidden units, the
        partial outputs summed; by rows its query rows through the whole
        block, the rows joined."""
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.d_model // cfg.num_heads
        ff = int(d * cfg.mlp_ratio)
        dt, n = x.dtype, x.shape[1]
        h0, h1, r0, r1 = tp.attention_split(cfg.num_heads, n, rows)
        c0, c1 = h0 * hd, h1 * hd
        f0, f1 = (0, ff) if rows else tp.span(ff)
        sh, s_sc, g = torch.chunk(blk.mod(sc), 3, dim=-1)
        h = tp.enter(_modulate(x, sh, s_sc))
        w = tp.take(blk.lin1, 1, 3 * d + ff, 0, 3 * d + ff).to(dt)
        b = tp.take(blk.lin1_b, 0, 3 * d + ff, 0, 3 * d + ff).to(dt)

        def cols(y, o0, o1):
            return torch.matmul(y, w[:, o0:o1]) + b[o0:o1]

        H = h1 - h0
        q = rmsnorm(tp.copy_to(blk.q_norm.scale),
                    _heads(cols(h[:, r0:r1], c0, c1), H))
        k = rmsnorm(tp.copy_to(blk.k_norm.scale),
                    _heads(cols(h, d + c0, d + c1), H))
        v = _heads(cols(h, 2 * d + c0, 2 * d + c1), H)
        attn = joint_attention(q, k, v, *rope, rows=(r0, r1), **attn_kw)
        mlp = gelu_tanh(cols(h[:, r0:r1], 3 * d + f0, 3 * d + f1))
        w2 = tp.take(blk.lin2, 0, d + ff, 0, d + ff).to(dt)
        out = (torch.matmul(attn, w2[c0:c1])
               + torch.matmul(mlp, w2[d + f0:d + f1]))
        out = tp.join(out, 1, n) if rows else tp.leave(out)
        return x + g[:, None] * (out + blk.lin2_b.to(dt))

    def forward(self, latents: torch.Tensor, t: torch.Tensor,
                txt: torch.Tensor, vec: torch.Tensor, *,
                ripple: RippleConfig = _RIPPLE_OFF,
                step: Optional[int] = None, total_steps: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                remat: bool = False, ctx=None) -> torch.Tensor:
        """latents (B, H_lat, W_lat, C); t (B,) rectified-flow time in [0,
        1]; txt (B, L, txt_dim) text embeddings; vec (B, 768) pooled
        conditioning.  Returns the velocity (B, H_lat, W_lat, C) in
        ``compute_dtype``.  ``remat`` recomputes each double and single
        block's activations in the backward pass (the reference's
        ``jax.checkpoint`` of both scan bodies).  ``ctx`` (a
        ``ShardCtx``) with a ``tp`` computes on this rank's model pieces
        (see the module docstring)."""
        cfg = self.cfg
        tp = ctx.tp if ctx is not None else None
        rows = ctx is not None and ctx.attn_rows
        if tp is not None and ripple.active():
            raise NotImplementedError(
                "attention under a model axis runs with ripple off (the "
                "train steps); serving there is ROADMAP §1 item 5")
        dt = compute_dtype
        B, Hl, Wl, C = latents.shape
        p = cfg.patch
        h, w = Hl // p, Wl // p
        grid = (1, h, w)
        L = txt.shape[1]
        n_img = h * w
        attn_kw = dict(grid=grid, grid_slice=(L, n_img), ripple=ripple,
                       step=step, total_steps=total_steps)

        img = patch_embed(self.img_in.w, self.img_in.b, latents.to(dt), p)
        txt_x = self.txt_in(txt.to(dt))
        temb = sincos_timestep_embed(t, 256).to(dt)
        c = self.t_mlp2(F.silu(self.t_mlp1(temb)))
        c = F.silu(c + self.vec_in(vec.to(dt)))
        sc = F.silu(c)  # every modulation reads silu(c)
        rope = joint_rope(L, grid, cfg.axes_dim, latents.device)

        def double_body(txt_x, img, ti, im):
            if tp is not None:
                return self._double_tp(txt_x, img, ti, im, sc, rope, attn_kw,
                                       tp, rows)
            t_sh, t_sc, *t_mods = torch.chunk(ti.mod(sc), 6, dim=-1)
            i_sh, i_sc, *i_mods = torch.chunk(im.mod(sc), 6, dim=-1)
            tq, tk, tv = self._qkv(ti, _modulate(txt_x, t_sh, t_sc))
            iq, ik, iv = self._qkv(im, _modulate(img, i_sh, i_sc))
            out = joint_attention(torch.cat([tq, iq], dim=1),
                                  torch.cat([tk, ik], dim=1),
                                  torch.cat([tv, iv], dim=1), *rope,
                                  **attn_kw)
            return (self._post(ti, txt_x, torch.matmul(out[:, :L],
                                                       ti.wo.to(dt)), t_mods),
                    self._post(im, img, torch.matmul(out[:, L:],
                                                     im.wo.to(dt)), i_mods))

        for ti, im in zip(self.double_blocks.txt, self.double_blocks.img):
            txt_x, img = remat_call(remat, double_body, txt_x, img, ti, im)

        x = torch.cat([txt_x, img], dim=1)
        d = cfg.d_model
        H = cfg.num_heads

        def single_body(x, blk):
            if tp is not None:
                return self._single_tp(x, blk, sc, rope, attn_kw, tp, rows)
            sh, s_sc, g = torch.chunk(blk.mod(sc), 3, dim=-1)
            fused = linear(blk.lin1, blk.lin1_b, _modulate(x, sh, s_sc))
            q, k, v = torch.split(fused[..., :3 * d], d, dim=-1)
            attn = joint_attention(rmsnorm(blk.q_norm.scale, _heads(q, H)),
                                   rmsnorm(blk.k_norm.scale, _heads(k, H)),
                                   _heads(v, H), *rope, **attn_kw)
            both = torch.cat([attn, gelu_tanh(fused[..., 3 * d:])], dim=-1)
            return x + g[:, None] * linear(blk.lin2, blk.lin2_b, both)

        for blk in self.single:
            x = remat_call(remat, single_body, x, blk)

        sh, f_sc = torch.chunk(self.final_mod(sc), 2, dim=-1)
        out = self.final(_modulate(x[:, L:], sh, f_sc))
        return unpatchify(out, p, h, w, C)


def mmdit_apply(model: MMDiT, latents: torch.Tensor, t: torch.Tensor,
                txt: torch.Tensor, vec: torch.Tensor,
                cfg: Optional[MMDiTConfig] = None, *,
                ripple: RippleConfig = _RIPPLE_OFF, step: Optional[int] = None,
                total_steps: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                remat: bool = False, ctx=None) -> torch.Tensor:
    """Functional form mirroring the JAX ``mmdit_apply``."""
    if cfg is not None and cfg != model.cfg:
        raise ValueError("cfg does not match the model's config")
    return model(latents, t, txt, vec, ripple=ripple, step=step,
                 total_steps=total_steps, compute_dtype=compute_dtype,
                 remat=remat, ctx=ctx)

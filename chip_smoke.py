#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. builds the port's CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc for sm_90a (one nvcc per source, started together);
2. holds the fused Δ-check + snap kernel bit for bit against its plain
   version (``core.reuse.compute_reuse``), bf16 and f32, channel and
   token gates, at the vDiT serving shape, a small shape, T = 1, and the
   DiT's T = 1 x/y case at head dim 72;
3. holds the pair-collapse attention kernel against f32 dense softmax on
   the same snapped operands, on constructed operands with collapse
   fractions 0, 0.6 and 1.0, an unaligned N, head dims 16 to 128 (72 on
   tensor cores, asserted) and both serving shapes;
4. holds the fused adaLN modulation kernel against its plain version,
   bf16 and f32, d 72 and 1152, ragged N, B > 1 with a different shift
   and scale per sample, and shift/scale read in place from chunks of the
   adaLN projection;
5. holds the block-sparse attention kernel against its plain semantics
   (f32, rounding where the kernel rounds) on all-FULL maps (and against
   ``scaled_dot_product_attention``), all-SKIP maps (exact zeros), mixed
   maps with -inf and finite PARTIAL biases, fully skipped rows, ragged
   and clamped N, an SVG map at the serving shape, and a constructed
   all-temporal map at batch 2 whose batch rows carry different biases;
6. times the kernels at the shapes their serving paths give them, their
   plain versions and, for attention, ``scaled_dot_product_attention``
   (for adaLN, ``F.layer_norm`` and its two elementwise ops: no single
   PyTorch call computes it) with CUDA events;
7. serves 3 requests of vdit-paper at full width through the port's
   DiffusionEngine three times - the ripple policy, ``--policy svg`` and
   ripple with ``svg_mask`` - each with the launch counters set to 0 just
   before and read just after, profiles one forward of the ripple and
   the SVG paths, then holds the sparse kernel against its plain
   semantics on one served SVG call at its full batch (operands and map
   kept on the host during the run, the bias rebuilt from q and k
   afterwards) and times it;
8. serves 4 requests of dit-xl2 at full width and depth (28 layers,
   gen_1024: 4096 tokens of head dim 72, 50 DDIM steps) in one batch,
   with the counters set to 0 just before and read just after: the
   adaLN, fused_reuse and ripple kernels must launch, the ripple kernel
   on tensor cores; then profiles one DiT forward at step 10;
9. checks a small trajectory of each of the four paths on the card
   against the same trajectory on the CPU.

It prints the card's name and power limit, one JSON line describing the
kernels, and as its last line ``{"ok": true, "device": {...}}``.  Any
mismatch or error exits non-zero.  It needs one card and no network.
``--layers N`` cuts the vDiT's served depth (default: all 40 layers);
the DiT always runs all 28.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense): device memory and arithmetic.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Float ops per element of the Δ-check: three window-2 Δ (9 ops each,
# shared by 2 elements), three compares, the first-wins select chain.
REUSE_OPS_PER_ELEM = 3 * 9 / 2 + 3 + 3

SERVE_OVERRIDES = ("model.frames=32",)  # 128 frames cut to 32: grid (8, 32, 32)
SERVE_STEPS = 12                        # step 10 snaps at θ=0.2, step 11 dense
SERVE_REQUESTS = 3
DIT_SHAPE = "gen_1024"  # (128, 128, 4) latents: a (1, 64, 64) grid, 50 steps
DIT_REQUESTS = 4         # the shape's batch
CARD = ""                # nvidia-smi's name and power limit, set in main()


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.bool: torch.uint8}[a.dtype]
    return bool(torch.equal(a.view(view), b.view(view)))


# ---------------------------------------------------------------------------
# Kernel 1: fused Δ-check + snap
# ---------------------------------------------------------------------------


def correlated(shape, dtype, seed, noise=0.6):
    """Tokens that share a per-(batch, head, channel) base plus independent
    noise: neighbours along t, x and y are correlated, so a θ of 0.2 snaps
    a fraction of every axis."""
    import torch

    B, H, N, d = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    base = torch.randn((B, H, 1, d), generator=g, device="cuda")
    return (base + noise * torch.randn((B, H, N, d), generator=g, device="cuda")).to(dtype).contiguous()


def check_reuse(results, shape, grid, dtype, gran, thetas, axes=("t", "x", "y")):
    import torch
    from repro_torch.core.reuse import compute_reuse
    from repro_torch.kernels.reuse_mask import ops as reuse_ops

    # The token gate averages Δ over channels: less noise, so it fires.
    x = correlated(shape, dtype, seed=len(results),
                   noise=0.6 if gran == "channel" else 0.3)
    th = dict(zip("txy", thetas))
    s_k, m_k = reuse_ops.fused_compute_reuse(x, grid, th, axes=axes,
                                             granularity=gran)
    ref = compute_reuse(x, grid, th, axes=axes, granularity=gran)
    torch.cuda.synchronize()
    ok = bits_equal(s_k, ref.snapped) and bits_equal(m_k, ref.mask)
    err = (s_k.float() - ref.snapped.float()).abs().max().item()
    fr = {a: round(ref.axis_masks[a].float().mean().item(), 4) for a in axes}
    name = str(dtype).replace("torch.", "")
    log(f"kernel fused_reuse {name:8s} {gran:7s} x{tuple(shape)} grid{grid} "
        f"axes={''.join(axes)}: bit-equal={ok} snapped={m_k.float().mean().item():.4f} "
        f"per-axis={fr}")
    results.append(ok)
    if not ok:
        raise SystemExit("fused_reuse kernel disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# Kernel 2: pair-collapse attention
# ---------------------------------------------------------------------------


def snapped_operand(shape, frac, seed, dtype, tile):
    """Pair-split operand with collapsed pairs: whole tiles of ``tile``
    pairs collapse with probability ``frac``, and so does every other
    pair, so collapsed, mixed and dense tiles all occur."""
    import torch

    B, H, N, d = shape
    P = N // 2
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((B, H, N, d), generator=g, device="cuda")
    ntile = -(-P // tile)
    tile_c = torch.rand((B, H, ntile, 1), generator=g, device="cuda") < frac
    pair_c = torch.rand((B, H, P, 1), generator=g, device="cuda") < frac
    coll = pair_c | tile_c.repeat_interleave(tile, dim=2)[:, :, :P]
    e, o = x[..., 0::2, :], x[..., 1::2, :]
    return torch.stack([e, torch.where(coll, e, o)], 3).reshape(
        B, H, N, d).to(dtype).contiguous()


def attention_oracle(q, k, v, scale, tensor_cores):
    """f32 dense softmax attention on the snapped (B, H, N, d) operands,
    one head at a time (bounded memory at 8448 tokens).  For the
    tensor-core path it rounds where that kernel rounds: the
    probabilities to bf16 before the PV product (the row sum stays f32),
    and v_even + v_odd of a collapsed key tile to bf16, that tile's two
    equal keys then carrying half of the rounded sum each (halving is
    exact).  The CUDA-core path rounds neither."""
    import torch
    from repro_torch.kernels.ripple.ops import TILE_PAIRS
    from repro_torch.kernels.ripple.ref import block_flags

    B, H, N, _ = q.shape
    out = torch.empty((B, H, N, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for h in range(H):
        qh, kh, vh = q[:, h].float(), k[:, h].float(), v[:, h].float()
        if tensor_cores:
            flags = block_flags(k[:, h], TILE_PAIRS).bool()  # (B, tiles)
            coll = flags.repeat_interleave(TILE_PAIRS, dim=1)[:, :N // 2]
            half = (vh[:, 0::2] + vh[:, 1::2]).bfloat16().float() * 0.5
            ve = torch.where(coll[..., None], half, vh[:, 0::2])
            vo = torch.where(coll[..., None], half, vh[:, 1::2])
            vh = torch.stack([ve, vo], 2).reshape(vh.shape)
        s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        if tensor_cores:
            p = p.bfloat16().float()
        out[:, h] = torch.matmul(p, vh) / l
    return out


# f32 (CUDA cores): summation order only, on O(1) values.  bf16: the
# kernel rounds its output to bf16 (at most 2^-9 of |out|) and rounds
# each probability against the running maximum of its row where the
# oracle rounds against the final one (at most one bf16 ulp per term,
# unbiased, so it averages out over the keys); four bf16 ulps of the
# largest output hold both with room, and stay well below what a wrong
# collapse branch (a row-sum weight of 1, a missing v_odd) moves.
def attn_tol(dtype_name, ref) -> float:
    if dtype_name == "float32":
        return 1e-4
    return 4 * 2.0 ** -8 * ref.abs().max().item()


def check_ripple(results, q, k, v, label):
    """The kernel against :func:`attention_oracle`; every bf16 case with a
    head dim of 32, 64, 72 or 128 must take the tensor cores."""
    import torch
    from repro_torch.kernels.ripple import ops as ripple_ops

    out = ripple_ops.ripple_attention(q, k, v)
    tc = ripple_ops.uses_tensor_cores(q, v)
    want_tc = (q.dtype == torch.bfloat16 and q.shape[-1] == v.shape[-1]
               and q.shape[-1] in (32, 64, 72, 128))
    ref = attention_oracle(q, k, v, ripple_ops.attention_scale(q.shape[-1]),
                           tc)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    name = str(q.dtype).replace("torch.", "")
    qf, kf, _ = ripple_ops.ripple_tile_stats(q, k, v.shape[-1])
    tol = attn_tol(name, ref)
    ok = err <= tol and bool(torch.isfinite(out).all()) and tc == want_tc
    path = "tensor cores" if tc else "CUDA cores"
    log(f"kernel ripple_attention {name:8s} {label} [{path}]: q tiles collapsed "
        f"{qf:.3f}, k tiles collapsed {kf:.3f}, max abs err vs f32 dense "
        f"{err:.3e} (tol {tol:.3g}) {'ok' if ok else 'FAIL'}")
    results.append(ok)
    if not ok:
        raise SystemExit("ripple kernel disagrees with dense attention, or "
                         "took the wrong path")
    return err


# ---------------------------------------------------------------------------
# Kernel 4: fused adaLN modulation
# ---------------------------------------------------------------------------


def adaln_excess(out, ref, x, shift, scale) -> float:
    """Largest error in units of its element's tolerance (pass at <= 1):
    one ulp of the output in its dtype (both sides round one float32
    value once), plus 2^-18 (32 float32 ulps) of the magnitudes the
    output is computed from, (|x| + |mean|) * rsqrt(var + eps) *
    |1 + scale| + |shift|.  Two float32 computations differ by a few
    float32 ulps of those (the mean's reduction order, rsqrt against
    1/sqrt), which shows only where x - mean or the final sum cancel to
    an output far smaller than its inputs.  A wrong sample's shift or
    scale, or a wrong row statistic, moves outputs by O(1)."""
    import torch

    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    r = torch.rsqrt(x32.var(-1, keepdim=True, correction=0) + 1e-6)
    terms = ((x32.abs() + mu.abs()) * r * (1 + scale.float()[:, None]).abs()
             + shift.float()[:, None].abs())
    mag = ref.float().abs().clamp(min=torch.finfo(torch.float32).tiny)
    mant = 7 if out.dtype == torch.bfloat16 else 23
    tol = torch.exp2(torch.floor(torch.log2(mag)) - mant) + 2.0 ** -18 * terms
    return ((out.float() - ref.float()).abs() / tol).max().item()


def check_adaln(results, B, N, d, dtype, seed, views=False):
    """One case against the plain version on the same card tensors; with
    ``views`` shift and scale are chunks of a (B, 6d) projection, as the
    DiT passes them.  Returns the max abs error."""
    import torch
    from repro_torch.kernels.adaln.ops import adaln_modulate
    from repro_torch.kernels.adaln.ref import adaln_modulate_ref

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = (3.0 + 2.0 * torch.randn((B, N, d), generator=g, device="cuda")).to(dtype)
    if views:
        ada = torch.randn((B, 6 * d), generator=g, device="cuda").to(dtype)
        _, scale, _, shift, _, _ = torch.chunk(ada, 6, dim=-1)
    else:
        shift, scale = (torch.randn((B, d), generator=g, device="cuda").to(dtype)
                        for _ in range(2))
    out = adaln_modulate(x, shift, scale)
    ref = adaln_modulate_ref(x, shift, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    excess = adaln_excess(out, ref, x, shift, scale)
    ok = excess <= 1.0 and out.dtype == dtype and bool(torch.isfinite(out).all())
    name = str(dtype).replace("torch.", "")
    log(f"kernel adaln {name:8s} x({B}, {N}, {d}){' shift/scale views' if views else ''}: "
        f"max abs err {err:.3e}, {excess:.3f} of tolerance (one {name} ulp of the "
        f"output + 2^-18 of its inputs' scale) {'ok' if ok else 'FAIL'}")
    results.append(ok)
    if not ok:
        raise SystemExit("adaln kernel disagrees with its plain version")
    return err


def adaln_checks():
    """Every adaLN case; returns the main path's (bf16, (4, 4096, 1152),
    views) max abs error."""
    import torch

    res = []
    serve_err = check_adaln(res, 4, 4096, 1152, torch.bfloat16, 40, views=True)
    for dt in (torch.bfloat16, torch.float32):
        for B, N, d in ((4, 4096, 1152), (2, 1000, 1152), (3, 37, 72), (1, 4096, 72),
                        (2, 256, 64)):
            check_adaln(res, B, N, d, dt, 41 + len(res))
        check_adaln(res, 2, 333, 72, dt, 60, views=True)
    log(f"kernel adaln: {sum(res)}/{len(res)} cases within tolerance")
    return serve_err


# ---------------------------------------------------------------------------
# Kernel 3: block-sparse masked attention
# ---------------------------------------------------------------------------

# Per-head (FULL, PARTIAL, SKIP) tiles of the SVG map at the serving grid
# (8, 32, 32) with 256 text tokens, 128x128 tiles: worked out from
# spatial_mask and temporal_mask, and checked against them below.
SVG_SPATIAL_TILES = (1220, 0, 3136)
SVG_TEMPORAL_TILES = (260, 1408, 2688)


def tile_counts(bmap):
    """(..., 3) int64 counts of FULL, PARTIAL, SKIP tiles per map."""
    import torch
    from repro_torch.kernels.sparse.ops import FULL, PARTIAL, SKIP

    return torch.stack([(bmap == st).sum((-1, -2)) for st in (FULL, PARTIAL, SKIP)], -1)


def tile_shares(bmap) -> str:
    c = tile_counts(bmap).reshape(-1, 3).sum(0).double()
    c = c / c.sum()
    return f"full {c[0].item():.3f} partial {c[1].item():.3f} skip {c[2].item():.3f}"


def sparse_oracle(q, k, v, bias, bmap, blk, round_p):
    """f32 block-sparse softmax attention with the kernel's conventions
    (FULL tiles ignore the bias, SKIP tiles drop out, the running max is
    floored at -1e30, a row with no live key emits 0), one head at a time.
    ``round_p`` rounds the probabilities to bf16 before the PV product,
    where the bf16 kernel rounds them (the row sum stays f32)."""
    import torch
    from repro_torch.kernels.sparse.ref import PARTIAL, SKIP, expand_block_map

    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    scale = float(1.0 / (d ** 0.5))
    out = torch.empty((B, H, Nq, v.shape[-1]), dtype=torch.float32, device=q.device)
    bm = bmap.expand(B, H, *bmap.shape[-2:])
    be = None if bias is None else bias.float().expand(B, H, Nq, Nk)
    for b in range(B):
        for h in range(H):
            s = torch.matmul(q[b, h].float(), k[b, h].float().T) * scale
            st = expand_block_map(bm[b, h], Nq, Nk, blk, blk)
            if be is not None:
                s = torch.where(st == PARTIAL, s + be[b, h], s)
            s = s.masked_fill(st == SKIP, float("-inf"))
            p = torch.exp(s - s.amax(-1, keepdim=True).clamp(min=-1e30))
            l = p.sum(-1, keepdim=True)
            if round_p:
                p = p.bfloat16().float()
            out[b, h] = torch.matmul(p, v[b, h].float()) / torch.where(
                l > 0, l, torch.ones_like(l))
            del s, st, p
    return out


def check_sparse(results, label, q, k, v, bias, bmap, blk, sdpa=False):
    """The kernel against :func:`sparse_oracle` at ``attn_tol`` (bf16
    rounds probabilities where the kernel does); an all-SKIP map must give
    exact zeros; ``sdpa`` also holds an all-FULL call against
    ``scaled_dot_product_attention``.  Returns the max abs error."""
    import torch
    from repro_torch.kernels.sparse import ops as sparse_ops
    from repro_torch.kernels.sparse.ref import SKIP

    out = sparse_ops.sparse_attention(q, k, v, bias=bias, block_map=bmap,
                                      block_q=blk, block_k=blk)
    tc = sparse_ops.uses_tensor_cores(q, v)
    ref = sparse_oracle(q, k, v, bias, bmap, blk, round_p=q.dtype == torch.bfloat16)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    name = str(q.dtype).replace("torch.", "")
    tol = attn_tol(name, ref)
    ok = err <= tol and bool(torch.isfinite(out).all())
    extra = ""
    if bool((bmap == SKIP).all()):
        zeros = bool((out == 0).all())
        ok = ok and zeros
        extra += f"; exact zeros={zeros}"
    if sdpa:
        # Two implementations each within attn_tol of the oracle: twice
        # its tolerance between them.  SDPA's f32 kernels keep about f32
        # accuracy (their products are split TF32 or full f32).
        lib = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=float(1.0 / (q.shape[-1] ** 0.5)))
        torch.cuda.synchronize()
        lib_err = (out.float() - lib.float()).abs().max().item()
        ok = ok and lib_err <= 2 * tol
        extra += f"; vs sdpa {lib_err:.3e} (tol {2 * tol:.3g})"
    path = "tensor cores" if tc else "CUDA cores"
    log(f"kernel sparse_attention {name:8s} {label} x{tuple(q.shape)} block {blk} "
        f"[{path}]: tiles {tile_shares(bmap)}; max abs err vs oracle {err:.3e} "
        f"(tol {tol:.3g}){extra} {'ok' if ok else 'FAIL'}")
    results.append(ok)
    if not ok:
        raise SystemExit("sparse kernel disagrees with its plain version")
    return err


def svg_serving_tiles(grid, n_txt, blk):
    """Per-head (FULL, PARTIAL, SKIP) tiles of a spatial and a temporal
    head's SVG map: spatial_mask / temporal_mask over the grid tokens,
    text rows and columns dense, tiled by block_map_from_keep."""
    import torch
    from repro_torch.core.svg_mask import spatial_mask, temporal_mask
    from repro_torch.kernels.sparse.ops import block_map_from_keep

    n = grid[0] * grid[1] * grid[2]
    out = []
    for mask in (spatial_mask(grid), temporal_mask(grid)):
        keep = torch.ones((n_txt + n,) * 2, dtype=torch.bool, device="cuda")
        keep[n_txt:, n_txt:] = torch.from_numpy(mask).cuda()
        out.append(tuple(int(c) for c in tile_counts(block_map_from_keep(keep, blk, blk))))
    return tuple(out)


def temporal_serving_call(grid, n_txt, heads=24, batch=1):
    """Serving-shape bf16 operands with every head's map the temporal SVG
    map (text rows and columns dense) and its -inf bias, one (N, N) f32
    slab per head as the served path holds it.  Batch rows after the
    first add a finite random term per head to that bias, so a kernel
    that reads another row's or head's bias disagrees."""
    import torch
    from repro_torch.core.svg_mask import temporal_mask
    from repro_torch.kernels.sparse.ops import block_map_from_keep

    n = grid[0] * grid[1] * grid[2]
    N = n_txt + n
    keep = torch.ones((N, N), dtype=torch.bool, device="cuda")
    keep[n_txt:, n_txt:] = torch.from_numpy(temporal_mask(grid)).cuda()
    bmap = block_map_from_keep(keep, 128, 128)
    bias = torch.where(keep, 0.0, float("-inf")).float().expand(
        batch, heads, N, N).contiguous()
    del keep
    g = torch.Generator(device="cuda")
    g.manual_seed(37)
    for b in range(1, batch):
        bias[b].add_(torch.randn((heads, N, N), generator=g, device="cuda"))
    q, k, v = (correlated((batch, heads, N, 128), torch.bfloat16, seed)
               for seed in (34, 35, 36))
    return q, k, v, bias, bmap


def sparse_checks(serve_grid, n_txt):
    """Every case of the sparse kernel against its plain semantics."""
    import torch
    from repro_torch.core.svg_mask import svg_logit_bias
    from repro_torch.kernels.sparse.ops import (FULL, PARTIAL, SKIP,
                                                block_map_from_keep, sparse_grid)

    res = []
    g = torch.Generator(device="cuda")
    g.manual_seed(30)

    def qkv(N, d, dt, H=2):
        return tuple(torch.randn((1, H, N, d), generator=g, device="cuda").to(dt)
                     for _ in range(3))

    def mixed_keep(N, H=2, blk=64):
        keep = torch.rand((1, H, N, N), generator=g, device="cuda") < 0.5
        keep[..., :blk, :blk] = True             # a FULL tile
        keep[..., blk:2 * blk, :blk] = False     # a SKIP tile
        return keep

    def neg_inf_bias(keep):
        return torch.where(keep, 0.0, float("-inf")).float()

    for dt in (torch.float32, torch.bfloat16):
        N, blk = 256, 64
        nb = sparse_grid(N, N, blk, blk)[2]
        q, k, v = qkv(N, 128, dt)
        check_sparse(res, "all FULL", q, k, v, None,
                     torch.full((nb, nb), FULL, dtype=torch.int32, device="cuda"), blk,
                     sdpa=True)
        check_sparse(res, "all SKIP", q, k, v, None,
                     torch.full((nb, nb), SKIP, dtype=torch.int32, device="cuda"), blk)
        keep = mixed_keep(N)
        check_sparse(res, "mixed, -inf bias", q, k, v, neg_inf_bias(keep),
                     block_map_from_keep(keep, blk, blk), blk)
        states = torch.randint(0, 3, (1, 2, nb, nb), generator=g, device="cuda",
                               dtype=torch.int32)
        bias = torch.randn((1, 2, N, N), generator=g, device="cuda")
        check_sparse(res, "random states, finite PARTIAL bias", q, k, v, bias,
                     states, blk)
        keep[..., 2 * blk:3 * blk, :] = False
        bmap = block_map_from_keep(keep, blk, blk)
        check_sparse(res, "a query row all SKIP", q, k, v, neg_inf_bias(keep), bmap, blk)
        for d in (64, 32, 16):
            q, k, v = qkv(N, d, dt)
            keep = mixed_keep(N)
            check_sparse(res, f"mixed, d={d}", q, k, v, neg_inf_bias(keep),
                         block_map_from_keep(keep, blk, blk), blk)
        for N, blk in ((130, 64), (8448 + 7, 128), (100, 128)):
            q, k, v = qkv(N, 128, dt)
            keep = mixed_keep(N, blk=min(blk, N // 2))
            check_sparse(res, f"mixed, N={N} ({'clamped' if N < blk else 'ragged'})",
                         q, k, v, neg_inf_bias(keep), block_map_from_keep(keep, blk, blk),
                         blk)
            del keep
    # Serving shape with an SVG map: correlated operands, heads classified
    # online, text tokens dense.
    n_grid = serve_grid[0] * serve_grid[1] * serve_grid[2]
    shape = (1, 24, n_txt + n_grid, 128)
    q, k, v = (correlated(shape, torch.bfloat16, seed) for seed in (31, 32, 33))
    keep, bias = svg_logit_bias(q, k, serve_grid, (n_txt, n_grid))
    bmap = block_map_from_keep(keep, 128, 128)
    del keep
    check_sparse(res, "serving shape, SVG map", q, k, v, bias, bmap, 128)
    del q, k, v, bias, bmap
    # Heads may all classify one way (random weights make every served
    # head spatial, with no PARTIAL tile); a constructed all-temporal map
    # covers the PARTIAL tiles and their dense bias at the serving shape,
    # at batch 2 with a different bias per batch row and head, so the
    # batch and head offsets into the bias are read on PARTIAL tiles.
    check_sparse(res, "serving shape, batch 2, temporal SVG map (constructed)",
                 *temporal_serving_call(serve_grid, n_txt, batch=2), 128)
    torch.cuda.empty_cache()

    sp, tm = svg_serving_tiles(serve_grid, n_txt, 128)
    ok = (sp, tm) == (SVG_SPATIAL_TILES, SVG_TEMPORAL_TILES)
    log(f"kernel sparse_attention: SVG map per head at grid {serve_grid} + {n_txt} text "
        f"tokens, (FULL, PARTIAL, SKIP) tiles: spatial {sp}, temporal {tm} "
        f"(expected {SVG_SPATIAL_TILES}, {SVG_TEMPORAL_TILES}) {'ok' if ok else 'FAIL'}")
    res.append(ok)
    if not ok:
        raise SystemExit("SVG serving maps do not have the expected tiles")
    log(f"kernel sparse_attention: {sum(res)}/{len(res)} cases within tolerance")


def sparse_bound(q, v, bias, bmap, blk):
    """(bound ms, 'bytes' or 'operations', flops, bytes) of one call: the
    products of the non-SKIP tiles (2*(d + dv) flops per score) at the
    bf16 peak against q, k, v and the output once, the map, and the f32
    bias of the PARTIAL tiles at the memory rate."""
    import torch
    from repro_torch.kernels.sparse.ops import PARTIAL, SKIP, sparse_grid

    B, H, Nq, d = q.shape
    Nk, dv = v.shape[2], v.shape[3]
    bq, bk, nq, nk = sparse_grid(Nq, Nk, blk, blk)
    rows = torch.tensor([min(bq, Nq - i * bq) for i in range(nq)], dtype=torch.float64)
    keys = torch.tensor([min(bk, Nk - j * bk) for j in range(nk)], dtype=torch.float64)
    area = rows[:, None] * keys[None, :]
    bm = bmap.expand(B, H, nq, nk).cpu()
    live = ((bm != SKIP).double() * area).sum().item()
    partial = ((bm == PARTIAL).double() * area).sum().item()
    elt = q.element_size()
    flops = 2.0 * (d + dv) * live
    nbytes = (elt * (B * H * (Nq * d + Nk * d + Nk * dv + Nq * dv)) + 4 * bm.numel()
              + (4 * partial if bias is not None else 0))
    t_ops = flops / PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        flops, nbytes


# ---------------------------------------------------------------------------
# Serving phases
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def wrapped(obj, name, make):
    """Shadow ``obj.name`` with ``make(original)`` for the duration."""
    had = name in vars(obj)
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        if had:
            setattr(obj, name, orig)
        else:
            delattr(obj, name)


def load_served_model(layers: int):
    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serving_shape
    from repro_torch.models.params import init_vdit

    arch = apply_overrides(get_config("vdit-paper"),
                           SERVE_OVERRIDES + (f"model.num_layers={layers}",))
    shape = serving_shape(arch, "gen_512", smoke=False, steps=SERVE_STEPS)
    m = arch.model
    grid = m.grid(img_res=shape.img_res)
    log(f"serve: vdit-paper full width d_model={m.d_model} heads="
        f"{m.num_heads}x{m.d_model // m.num_heads} mlp={int(m.d_model * m.mlp_ratio)} "
        f"text={m.txt_tokens}x{m.txt_dim} axes={m.axes_dim}; cuts: frames "
        f"128->{m.frames} (grid {grid}, {grid[0] * grid[1] * grid[2] + m.txt_tokens} "
        f"tokens), layers 40->{m.num_layers}, {SERVE_STEPS} DDIM steps")
    t0 = time.perf_counter()
    model = init_vdit(m, seed=0, device="cuda", dtype=torch.bfloat16, zero_init=False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: {n_params / 1e9:.3f} B params (bf16, every leaf drawn from "
        f"a seeded generator at fan-in scale) in {time.perf_counter() - t0:.1f}s")
    return arch, shape, model


def serve_phase(label, arch, shape, model, *, policy=None, launched=(), absent=(),
                requests=SERVE_REQUESTS):
    """Serve ``requests`` requests in one batch through the port's
    DiffusionEngine with the launch counters set to 0 just before and
    read just after; each kernel in ``launched`` must have run, none in
    ``absent``."""
    import numpy as np
    import torch
    from repro_torch.core import dispatch as dispatch_lib
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_sampler
    from repro_torch.launch.workloads import attention_tokens, mixed_request_stream
    from repro_torch.serving.engine import DiffusionEngine

    m = arch.model
    sample_fn, lat_shape = build_sampler(arch, shape, model, policy=policy)
    qk = (1, m.num_heads, attention_tokens(arch, shape), m.d_model // m.num_heads)
    plan = dispatch_lib.resolve_plan(qk, qk, arch.ripple, on_cuda=True, policy=policy)
    log(f"serve[{label}]: plan {plan.summary()}; ripple {arch.ripple}"
        f"{'' if policy is None else f', policy {policy}'}")
    engine = DiffusionEngine(lambda shp, steps: sample_fn, device="cuda",
                             max_batch=requests)
    traffic = mixed_request_stream(arch, (shape,), requests, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for _, req in traffic:  # all queued before the worker starts: one batch
        engine.submit(req)
    engine.start()
    try:
        results = [engine.result(req.request_id) for _, req in traffic]
    finally:
        engine.stop()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r in results:
        log(f"serve[{label}]: request {r.request_id} latency {r.latency_s:.3f}s "
            f"(batch {r.batch_index} of {requests} served in "
            f"{r.walltime_s:.3f}s); latents {r.latents.shape}; {CARD}")
        if r.latents.shape != lat_shape:
            raise SystemExit(f"latents {r.latents.shape} != {lat_shape}")
        if not np.isfinite(r.latents).all():
            raise SystemExit("served latents are not finite")
    log(f"serve[{label}]: launches {counts}; peak device memory {peak:.2f} GiB; {CARD}")
    if len({r.batch_index for r in results}) != 1:
        raise SystemExit(f"serve[{label}]: the requests did not share one batch")
    if any(counts[n] <= 0 for n in launched):
        raise SystemExit(f"serve[{label}]: a kernel of the path never launched: {counts}")
    if any(counts[n] != 0 for n in absent):
        raise SystemExit(f"serve[{label}]: a kernel off the path launched: {counts}")
    return counts, results, lat_shape


def serve_ripple(arch, shape, model, label="ripple", **phase):
    """The ripple policy (PR 11's path): fused Δ-check + pair collapse.
    Reads the policy's snap masks at step 10 (grid tokens only) and the
    share of ripple-kernel tiles that collapse there, by shadowing the
    policy's methods on the registered instance and the kernel wrapper
    for this run only; every ripple call's (dtype, d, dv, tensor cores)
    is recorded.  ``phase`` goes to :func:`serve_phase`."""
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels.ripple import ops as ripple_ops

    pol = get_policy("ripple")
    snaps = {"q": [], "k": [], "qt": [], "kt": []}
    current = {"step": None}
    paths = set()

    def thetas_for(orig):
        def f(cfg, step, total_steps, thetas=None):
            current["step"] = step
            return orig(cfg, step, total_steps, thetas)
        return f

    def decide(orig):
        def f(q, k, **kw):
            d = orig(q, k, **kw)
            if current["step"] == 10:
                s, n = kw["grid_slice"] or (0, q.shape[-2])
                snaps["q"].append(d.q_mask.narrow(-2, s, n).float().mean())
                snaps["k"].append(d.k_mask.narrow(-2, s, n).float().mean())
            return d
        return f

    def kernel(orig):
        def f(q, k, v, **kw):
            paths.add((str(q.dtype).replace("torch.", ""), q.shape[-1], v.shape[-1],
                       ripple_ops.uses_tensor_cores(q, v)))
            if current["step"] == 10:
                qt, kt, _ = ripple_ops.ripple_tile_stats(q, k, v.shape[-1])
                snaps["qt"].append(qt)
                snaps["kt"].append(kt)
            return orig(q, k, v, **kw)
        return f

    phase = {"launched": ("fused_reuse", "ripple_attention"),
             "absent": ("sparse_attention",), **phase}
    with wrapped(pol, "thetas_for", thetas_for), wrapped(pol, "decide", decide), \
            wrapped(ripple_ops, "ripple_attention", kernel):
        counts, results, lat_shape = serve_phase(label, arch, shape, model, **phase)
    q_snap = torch.stack(snaps["q"]).mean().item() if snaps["q"] else 0.0
    k_snap = torch.stack(snaps["k"]).mean().item() if snaps["k"] else 0.0
    qt = sum(snaps["qt"]) / max(len(snaps["qt"]), 1)
    kt = sum(snaps["kt"]) / max(len(snaps["kt"]), 1)
    log(f"serve[{label}]: snap fraction at step 10: Q {q_snap:.4f} K {k_snap:.4f}; "
        f"ripple tiles collapsed there: Q {qt:.4f} K {kt:.4f}; ripple calls (dtype, d, "
        f"dv, tensor cores): {sorted(paths)}")
    if q_snap <= 0 or k_snap <= 0:
        raise SystemExit("no snapping at step 10")
    return counts, lat_shape, paths


def serve_svg(label, arch, shape, model, *, policy, launched, absent, capture=None):
    """A path under the SVG block mask.  Records each call's per-head
    verdict and per-head tile counts (shadowing the policy's decide and
    ``svg_mask.classify_heads`` for this run only) and holds every head's
    map to the tiles its verdict implies.  ``capture`` receives host
    copies of the first sparse call's operands and map at its full batch
    (nothing of it stays on the card, so it adds nothing to a measured
    peak; the bias is rebuilt from q and k later)."""
    import torch
    from repro_torch.core import svg_mask
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels.sparse import ops as sparse_ops

    pol = get_policy(policy or arch.ripple.policy)
    tiles, verdicts = [], []

    def decide(orig):
        def f(q, k, **kw):
            d = orig(q, k, **kw)
            tiles.append(tile_counts(d.block_map))
            return d
        return f

    def classify(orig):
        def f(*a, **kw):
            v = orig(*a, **kw)
            verdicts.append(v)
            return v
        return f

    def grab(orig):
        def f(q, k, v, **kw):
            if capture is not None and not capture:
                capture.update(q=q.cpu(), k=k.cpu(), v=v.cpu(),
                               block_map=kw["block_map"].cpu(),
                               block=kw["block_q"])
            return orig(q, k, v, **kw)
        return f

    with wrapped(pol, "decide", decide), wrapped(svg_mask, "classify_heads", classify), \
            wrapped(sparse_ops, "sparse_attention", grab):
        counts, results, _ = serve_phase(label, arch, shape, model, policy=policy,
                                         launched=launched, absent=absent)
    t = torch.stack(tiles).cpu()        # (calls, B, H, 3)
    v = torch.stack(verdicts).cpu()     # (calls, B, H)
    want = torch.where(v[..., None], torch.tensor(SVG_SPATIAL_TILES),
                       torch.tensor(SVG_TEMPORAL_TILES))
    ok = t.shape == want.shape and torch.equal(t, want)
    tot = t.reshape(-1, 3).sum(0).double()
    tot = tot / tot.sum()
    log(f"serve[{label}]: {v.numel()} head maps over {t.shape[0]} calls; share of "
        f"heads classified spatial {v.float().mean().item():.4f}; tile shares full "
        f"{tot[0].item():.4f} partial {tot[1].item():.4f} skip {tot[2].item():.4f}; every "
        f"head's map has its verdict's tiles: {ok}")
    if not ok:
        raise SystemExit(f"serve[{label}]: a served map disagrees with its head's verdict")
    return counts


def serve_dit():
    """dit-xl2 at full width and depth (28 layers, d_model 1152, 16 heads
    of 72) on gen_1024: 4 requests in one batch through the ripple
    policy.  The adaLN, fused_reuse and ripple kernels must launch, the
    sparse kernel must not, and every ripple call must take the tensor
    cores; then one forward at step 10 is profiled."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serving_shape
    from repro_torch.models.params import init_dit

    arch = get_config("dit-xl2")
    shape = serving_shape(arch, DIT_SHAPE, smoke=False)
    m = arch.model
    hw = m.latent_res(shape.img_res) // m.patch
    log(f"serve: dit-xl2 full width and depth d_model={m.d_model} heads="
        f"{m.num_heads}x{m.d_model // m.num_heads} layers={m.num_layers} "
        f"mlp={int(m.d_model * m.mlp_ratio)}; {shape.name}: img_res {shape.img_res}, "
        f"grid (1, {hw}, {hw}) = {hw * hw} tokens, {shape.steps} DDIM steps, "
        f"{DIT_REQUESTS} requests; no cuts")
    t0 = time.perf_counter()
    model = init_dit(m, seed=0, device="cuda", dtype=torch.bfloat16, zero_init=False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: {n_params / 1e9:.3f} B params (bf16, every leaf drawn from a seeded "
        f"generator, the adaLN-zero and final leaves too) in "
        f"{time.perf_counter() - t0:.1f}s")
    counts, lat_shape, paths = serve_ripple(
        arch, shape, model, "dit-xl2", requests=DIT_REQUESTS,
        launched=("adaln", "fused_reuse", "ripple_attention"))
    if not paths or not all(tc for *_, tc in paths):
        raise SystemExit("serve[dit-xl2]: the ripple kernel left the tensor cores")
    profile_forward("dit-xl2", arch, model, lat_shape,
                    {"ripple_attention": "ripple", "fused_reuse": "fused_reuse",
                     "adaln": "adaln"}, batch=DIT_REQUESTS, total=shape.steps)
    del model
    torch.cuda.empty_cache()
    return counts


def profile_forward(label, arch, model, lat_shape, families, annotate=None,
                    batch=SERVE_REQUESTS, total=SERVE_STEPS):
    """Device time by kernel family over one served-size denoiser forward
    (step 10 of ``total``: snapping on), from torch.profiler, the device's
    idle share of that forward's wall time, and its peak device memory.
    ``families`` maps a family to a kernel-name substring;
    ``annotate = (obj, attr, family)`` wraps ``obj.attr`` in a profiler
    range and counts every kernel launched inside it as ``family``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch.workloads import _denoise_call

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.randn((batch, *lat_shape), generator=g, device="cuda")
    m = arch.model
    if arch.family == "dit":
        cond = {"labels": torch.randint(0, m.num_classes, (batch,), generator=g,
                                        device="cuda")}
    else:
        cond = {"txt": 0.05 * torch.randn((batch, m.txt_tokens, m.txt_dim),
                                          generator=g, device="cuda")}
    t = torch.full((batch,), 200.0, device="cuda")

    def fwd():
        return _denoise_call(arch, model, x, t, cond, 10, total)

    def family(name):
        name = name.lower()
        for fam, key in families.items():
            if key in name:
                return fam
        if "gemm" in name or "cutlass" in name or "xmma" in name or "nvjet" in name:
            return "gemm"
        return "other"

    fwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx = contextlib.nullcontext()
    if annotate is not None:
        obj, attr, ann = annotate

        def ranged(orig):
            def f(*a, **kw):
                with record_function(ann):
                    return orig(*a, **kw)
            return f

        ctx = wrapped(obj, attr, ranged)
    with ctx, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    fam = {k: 0.0 for k in families}
    fam.update(gemm=0.0, other=0.0)
    spans = []
    events = prof.events()
    for ev in events:  # device-side activities only (kernels, copies)
        if ev.device_type != DeviceType.CUDA:
            continue
        if annotate is not None and ev.name == annotate[2]:
            continue  # the range's own span on the device timeline
        spans.append((ev.time_range.start, ev.time_range.end))
        fam[family(ev.name)] += ev.time_range.elapsed_us()
    by_name = {}
    if annotate is not None:
        # Kernels launched by host ops inside the range move to its family.
        ann = annotate[2]
        fam[ann] = 0.0
        for ev in events:
            if ev.device_type != DeviceType.CPU or not ev.kernels:
                continue
            p = ev.cpu_parent
            while p is not None and p.name != ann:
                p = p.cpu_parent
            if p is None:
                continue
            for kern in ev.kernels:
                fam[family(kern.name)] -= kern.duration
                fam[ann] += kern.duration
                key = f"{ev.name}: {kern.name[:48]}"
                by_name[key] = by_name.get(key, 0.0) + kern.duration
    # Busy time is the union of the device intervals; on one stream it
    # equals their sum, so a sum above the union means an event was
    # counted twice, and either above the wall time is a broken reading.
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms, sum_ms = busy_us / 1e3, sum(fam.values()) / 1e3
    if busy_ms <= 0:
        raise SystemExit(f"profile[{label}]: the profiler reported no device time")
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in fam.items())
    log(f"profile[{label}]: one forward, batch {batch}, "
        f"{arch.model.num_layers} layers, step 10 of {total}: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms (sum of events {sum_ms:.3f} ms; idle "
        f"share {1 - busy_ms / wall_ms:.4f}); {parts}; peak device memory "
        f"{peak:.2f} GiB")
    if by_name:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"profile[{label}]: {annotate[2]} by host op and kernel: " + "; ".join(
            f"{k} {v / 1e3:.3f} ms" for k, v in top))
    if sum_ms > 1.01 * busy_ms or busy_ms > wall_ms or min(fam.values()) < 0:
        raise SystemExit(f"profile[{label}]: device time exceeds its span or the wall "
                         "time; the reading is not usable")
    if annotate is not None and fam[annotate[2]] <= 0:
        raise SystemExit(f"profile[{label}]: no kernel attributed to {annotate[2]}")


def small_reference_check(label, name="vdit-paper", policy=None, overrides=()):
    """The smoke config's 12-step trajectory in f32 through the kernels on
    the card against the same trajectory through the plain versions on
    the CPU, same params, noise and conditioning (the DiT's class label
    comes from the request seed on the CPU)."""
    import numpy as np
    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import build_sampler, serving_shape
    from repro_torch.models.params import init_dit, init_vdit
    from repro_torch.serving.engine import request_noise

    arch = apply_overrides(get_smoke_config(name), overrides)
    init = init_dit if arch.family == "dit" else init_vdit
    shape_name = next(sp.name for sp in arch.shapes if sp.kind == "generate")
    shape = serving_shape(arch, shape_name, smoke=True, steps=SERVE_STEPS)
    txt_shape = (1, getattr(arch.model, "txt_tokens", 8),
                 getattr(arch.model, "txt_dim", 64))
    outs = {}
    for dev in ("cuda", "cpu"):
        model = init(arch.model, seed=1, device="cpu", zero_init=False)
        model = model.to(dev)
        fn, lat_shape = build_sampler(arch, shape, model, policy=policy,
                                      compute_dtype=torch.float32)
        noise = request_noise(5, lat_shape, "cpu")[None].to(dev)
        txt = torch.from_numpy(0.05 * np.random.default_rng(5).standard_normal(
            txt_shape).astype(np.float32)).to(dev)
        outs[dev] = fn(noise, txt, [5]).float().cpu()
    diff = (outs["cuda"] - outs["cpu"]).norm() / outs["cpu"].norm()
    ok = bool(torch.isfinite(outs["cuda"]).all()) and diff.item() < 1e-3
    log(f"reference[{label}]: {arch.name} {shape.img_res}² 12-step f32 trajectory, "
        f"card kernels vs CPU "
        f"plain versions: relative L2 {diff.item():.3e} (tol 1e-3) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("card trajectory disagrees with the CPU reference")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=40,
                    help="served depth (the full model has 40)")
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    global CARD
    card = CARD = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build --------------------------------------------------------------
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}; "
        f"{time.perf_counter() - t0:.1f}s wall for {len(built)} sources")
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"build: {name}: {info['path']} ({info['seconds']:.1f}s) "
            f"{' | '.join(regs)}")

    from repro_torch.kernels.reuse_mask import ops as reuse_ops
    from repro_torch.kernels.ripple import ops as ripple_ops
    from repro_torch.kernels.ripple.ref import ripple_attention_ref

    bf16, f32 = torch.bfloat16, torch.float32
    serve_grid = (8, 32, 32)
    n_grid = 8 * 32 * 32
    serve_qk = (1, 24, n_grid, 128)

    # 2. kernel 1 vs its plain version --------------------------------------
    res1 = []
    th = (0.2, 0.25, 0.3)
    # The main path's case (bf16, channel gate, serving shape) first: its
    # max abs error goes into the JSON line.
    serve_err1 = check_reuse(res1, serve_qk, serve_grid, bf16, "channel", th)
    for dt in (bf16, f32):
        for gran in ("channel", "token"):
            if (dt, gran) != (bf16, "channel"):
                check_reuse(res1, serve_qk, serve_grid, dt, gran, th)
            check_reuse(res1, (2, 3, 4 * 6 * 8, 64), (4, 6, 8), dt, gran, th)
            check_reuse(res1, (1, 2, 8 * 8, 32), (1, 8, 8), dt, gran, th)
    check_reuse(res1, (1, 2, 4 * 6 * 8, 64), (4, 6, 8), bf16, "channel", th,
                axes=("y", "t", "x"))
    # The DiT's case: T = 1 (the one-frame instance), x/y axes, head dim 72
    # at dit-xl2's gen_1024 shape.
    dit_grid = (1, 64, 64)
    dit_qk = (DIT_REQUESTS, 16, 64 * 64, 72)
    for dt in (bf16, f32):
        for gran in ("channel", "token"):
            check_reuse(res1, dit_qk, dit_grid, dt, gran, th, axes=("x", "y"))
    log(f"kernel fused_reuse: {sum(res1)}/{len(res1)} cases bit-equal")

    # 3. kernel 2 vs f32 dense attention on the snapped operands ------------
    res2 = []
    tile = ripple_ops.TILE_PAIRS
    for dt in (f32, bf16):
        for frac in (0.0, 0.6, 1.0):
            q = snapped_operand((1, 2, 256, 64), frac, 1, dt, tile)
            k = snapped_operand((1, 2, 256, 64), frac, 2, dt, tile)
            v = snapped_operand((1, 2, 256, 64), 0.0, 3, dt, tile)
            check_ripple(res2, q, k, v, f"N=256 d=64 frac={frac}")
        for frac in (0.0, 0.6, 1.0):
            q = snapped_operand((1, 2, 256, 72), frac, 13, dt, tile)
            k = snapped_operand((1, 2, 256, 72), frac, 14, dt, tile)
            v = snapped_operand((1, 2, 256, 72), 0.0, 15, dt, tile)
            check_ripple(res2, q, k, v, f"N=256 d=72 frac={frac}")
        for d in (16, 32, 72):
            for frac in (0.6, 1.0):
                q = snapped_operand((1, 2, 130, d), frac, 4, dt, tile)
                k = snapped_operand((1, 2, 130, d), frac, 5, dt, tile)
                v = snapped_operand((1, 2, 130, d), 0.0, 6, dt, tile)
                check_ripple(res2, q, k, v,
                             f"N=130 d={d} frac={frac} (unaligned)")
    n_tok = n_grid + 256
    serve_qkv = (1, 24, n_tok, 128)
    q = snapped_operand(serve_qkv, 0.6, 7, bf16, tile)
    k = snapped_operand(serve_qkv, 0.6, 8, bf16, tile)
    v = snapped_operand(serve_qkv, 0.0, 9, bf16, tile)
    check_ripple(res2, q, k, v, f"N={n_tok} d=128 frac=0.6 (serving shape)")
    # Serving-shape operands as the main path makes them: text tokens
    # first, then grid tokens snapped by kernel 1 at θ = 0.2.
    qk = []
    for seed in (10, 11):
        x = correlated(serve_qkv, bf16, seed)
        seg, _ = reuse_ops.fused_compute_reuse(
            x[:, :, 256:].contiguous(), serve_grid, dict(zip("txy", (0.2,) * 3)))
        qk.append(torch.cat([x[:, :, :256], seg], dim=2).contiguous())
    v = correlated(serve_qkv, bf16, 12)
    serve_err = check_ripple(res2, qk[0], qk[1], v,
                             f"N={n_tok} d=128 main-path snapped operands")
    # dit-xl2 at gen_1024: (4, 16, 4096, 72), constructed and as the DiT's
    # path makes them (all tokens grid tokens, snapped on x/y at θ = 0.2).
    check_ripple(res2, *(snapped_operand(dit_qk, frac, seed, bf16, tile)
                         for frac, seed in ((0.6, 16), (0.6, 17), (0.0, 18))),
                 f"{dit_qk} frac=0.6 (dit-xl2 serving shape)")
    dit_q, dit_k = (reuse_ops.fused_compute_reuse(
        correlated(dit_qk, bf16, seed), dit_grid, dict(zip("txy", (0.2,) * 3)),
        axes=("x", "y"))[0] for seed in (19, 20))
    dit_v = correlated(dit_qk, bf16, 21)
    check_ripple(res2, dit_q, dit_k, dit_v,
                 f"{dit_qk} dit-xl2 main-path snapped operands")
    log(f"kernel ripple_attention: {sum(res2)}/{len(res2)} cases within "
        f"tolerance")

    # 4. kernel 4 (adaLN) vs its plain version -------------------------------
    adaln_err = adaln_checks()

    # 5. kernel 3 vs its plain semantics -------------------------------------
    sparse_checks(serve_grid, 256)

    # 6. times at the serving shapes (bf16) ---------------------------------
    from repro_torch.core.reuse import compute_reuse

    x1 = correlated(serve_qk, bf16, 20)
    th1 = dict(zip("txy", (0.2,) * 3))
    k1_ms = cuda_time_ms(lambda: reuse_ops.fused_compute_reuse(x1, serve_grid, th1))
    k1_plain = cuda_time_ms(lambda: compute_reuse(x1, serve_grid, th1), iters=3)
    n1 = x1.numel()
    k1_bytes = n1 * (2 + 2 + 1)
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S,
                   n1 * REUSE_OPS_PER_ELEM / PEAK_FLOPS["float32"]) * 1e3
    k1_by = ("bytes" if k1_bytes / HBM_BYTES_PER_S
             >= n1 * REUSE_OPS_PER_ELEM / PEAK_FLOPS["float32"] else "operations")
    log(f"time fused_reuse bf16 {tuple(serve_qk)}: kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain:.4f} ms, bound {k1_bound:.4f} ms ({k1_by}: {k1_bytes / 1e6:.1f} MB)")

    q, k = qk
    k2_ms = cuda_time_ms(lambda: ripple_ops.ripple_attention(q, k, v), iters=5)
    scale = ripple_ops.attention_scale(128)
    k2_plain = cuda_time_ms(lambda: ripple_attention_ref(q, k, v, scale), iters=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k2_lib = cuda_time_ms(lambda: sdpa(q, k, v, scale=scale), iters=10)
    _, _, flops = ripple_ops.ripple_tile_stats(q, k, 128)
    k2_bytes = 4 * q.numel() * 2
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]) * 1e3
    k2_by = ("operations" if flops / PEAK_FLOPS["bfloat16"]
             >= k2_bytes / HBM_BYTES_PER_S else "bytes")
    log(f"time ripple_attention bf16 {tuple(serve_qkv)}: kernel {k2_ms:.4f} ms "
        f"({flops / k2_ms / 1e9:.2f} TFLOP/s), plain {k2_plain:.4f} ms, sdpa "
        f"{k2_lib:.4f} ms, bound {k2_bound:.4f} ms ({k2_by}: {flops / 1e12:.4f} "
        f"TFLOP)")
    del x1, q, k, v, qk

    xd = correlated(dit_qk, bf16, 22)
    thd = dict(zip("txy", (0.2,) * 3))
    kd_ms = cuda_time_ms(lambda: reuse_ops.fused_compute_reuse(
        xd, dit_grid, thd, axes=("x", "y")))
    kd_plain = cuda_time_ms(lambda: compute_reuse(xd, dit_grid, thd, axes=("x", "y")),
                            iters=3)
    kd_bytes = xd.numel() * (2 + 2 + 1)
    log(f"time fused_reuse bf16 {dit_qk} grid {dit_grid} axes xy (dit-xl2): kernel "
        f"{kd_ms:.4f} ms, plain {kd_plain:.4f} ms, bound "
        f"{kd_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes: {kd_bytes / 1e6:.1f} MB)")
    del xd

    q, k, v = dit_q, dit_k, dit_v
    r_ms = cuda_time_ms(lambda: ripple_ops.ripple_attention(q, k, v), iters=5)
    scale = ripple_ops.attention_scale(72)
    r_plain = cuda_time_ms(lambda: ripple_attention_ref(q, k, v, scale), iters=3)
    r_lib = cuda_time_ms(lambda: sdpa(q, k, v, scale=scale), iters=10)
    _, _, r_flops = ripple_ops.ripple_tile_stats(q, k, 72)
    r_bytes = 4 * q.numel() * 2
    r_bound = max(r_bytes / HBM_BYTES_PER_S, r_flops / PEAK_FLOPS["bfloat16"]) * 1e3
    log(f"time ripple_attention bf16 {dit_qk} (dit-xl2, tensor cores "
        f"{ripple_ops.uses_tensor_cores(q, v)}): kernel {r_ms:.4f} ms "
        f"({r_flops / r_ms / 1e9:.2f} TFLOP/s), plain {r_plain:.4f} ms, sdpa "
        f"{r_lib:.4f} ms, bound {r_bound:.4f} ms (operations: {r_flops / 1e12:.4f} "
        f"TFLOP)")
    del q, k, v, dit_q, dit_k, dit_v

    # adaLN at the DiT's main-path shape, shift/scale chunks of the
    # projection as the model passes them.
    from repro_torch.kernels.adaln.ops import adaln_modulate
    from repro_torch.kernels.adaln.ref import adaln_modulate_ref

    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    xa = torch.randn((DIT_REQUESTS, 4096, 1152), generator=g, device="cuda").to(bf16)
    ada = torch.randn((DIT_REQUESTS, 6 * 1152), generator=g, device="cuda").to(bf16)
    sha, sca = torch.chunk(ada, 6, dim=-1)[:2]
    a_ms = cuda_time_ms(lambda: adaln_modulate(xa, sha, sca), iters=20)
    a_plain = cuda_time_ms(lambda: adaln_modulate_ref(xa, sha, sca), iters=10)
    layer_norm = torch.nn.functional.layer_norm
    a_lib = cuda_time_ms(lambda: layer_norm(xa, (1152,), eps=1e-6)
                         * (1 + sca[:, None]) + sha[:, None], iters=20)
    a_bytes = 2 * xa.numel() * 2 + 2 * sha.numel() * 2
    a_ops = 10 * xa.numel()
    a_bound = max(a_bytes / HBM_BYTES_PER_S, a_ops / PEAK_FLOPS["float32"]) * 1e3
    a_by = "bytes" if a_bytes / HBM_BYTES_PER_S >= a_ops / PEAK_FLOPS["float32"] \
        else "operations"
    log(f"time adaln bf16 {tuple(xa.shape)}: kernel {a_ms:.4f} ms "
        f"({a_bytes / a_ms / 1e6:.1f} GB/s), plain {a_plain:.4f} ms, F.layer_norm "
        f"and two elementwise ops {a_lib:.4f} ms (no single PyTorch call), bound "
        f"{a_bound:.4f} ms ({a_by}: {a_bytes / 1e6:.1f} MB)")
    del xa, ada, sha, sca
    torch.cuda.empty_cache()

    # 7. serving phases: each path with the launch counters set to 0 just
    # before it and read just after -------------------------------------------
    from repro_torch.config.base import apply_overrides
    from repro_torch.core.policy import get_policy
    from repro_torch.core.svg_mask import svg_logit_bias
    from repro_torch.kernels.sparse import ops as sparse_ops
    from repro_torch.kernels.sparse.ops import block_map_from_keep
    from repro_torch.kernels.sparse.ref import FULL, sparse_attention_ref

    arch, shape, model = load_served_model(args.layers)
    counts_r, lat_shape, _ = serve_ripple(arch, shape, model)
    profile_forward("ripple", arch, model, lat_shape,
                    {"ripple_attention": "ripple", "fused_reuse": "fused_reuse"})
    served = {}
    counts_s = serve_svg("svg", arch, shape, model, policy="svg",
                         launched=("sparse_attention",),
                         absent=("ripple_attention", "fused_reuse"), capture=served)
    profile_forward("svg", apply_overrides(arch, ("ripple.policy=svg",)), model,
                    lat_shape, {"sparse_attention": "sparse"},
                    annotate=(get_policy("svg"), "decide", "svg_mask"))
    serve_svg("ripple+svg", apply_overrides(arch, ("ripple.svg_mask=true",)), shape,
              model, policy=None, launched=("fused_reuse", "sparse_attention"),
              absent=("ripple_attention",))
    del model
    torch.cuda.empty_cache()

    # 7b. kernel 3 on a served SVG call: check and times --------------------
    # The call's operands and map at its full batch, back on the card; its
    # keep mask and bias rebuilt from q and k as the policy built them
    # (the rebuilt map must be the served one).
    q, k, v = (served[n].cuda() for n in "qkv")
    bmap, blk = served["block_map"].cuda(), served["block"]
    del served
    keep, bias = svg_logit_bias(q, k, serve_grid, (256, n_grid))
    same = torch.equal(block_map_from_keep(keep, blk, blk), bmap)
    del keep
    log(f"kernel sparse_attention: served SVG call {tuple(q.shape)}: map rebuilt "
        f"from its q and k equals the served map: {same}")
    if not same:
        raise SystemExit("the rebuilt SVG map differs from the served one")
    serve_err3 = check_sparse([], "main-path operands (a served SVG call)", q, k, v,
                              bias, bmap, blk)
    b_ms = cuda_time_ms(lambda: sparse_ops.sparse_attention(
        q, k, v, bias=bias, block_map=bmap, block_q=blk, block_k=blk), iters=5)
    b_bound, b_by, _, _ = sparse_bound(q, v, bias, bmap, blk)
    log(f"time sparse_attention bf16 {tuple(q.shape)} block {blk}, the served SVG "
        f"call: kernel {b_ms:.4f} ms, bound {b_bound:.4f} ms ({b_by})")
    # The plain version and SDPA hold whole (B, H, N, N) score matrices:
    # the three are timed on batch row 0 of the call.
    q, k, v, bias, bmap = (t[:1].clone() for t in (q, k, v, bias, bmap))
    torch.cuda.empty_cache()
    scale = float(1.0 / (q.shape[-1] ** 0.5))
    k3_ms = cuda_time_ms(lambda: sparse_ops.sparse_attention(
        q, k, v, bias=bias, block_map=bmap, block_q=blk, block_k=blk))
    k3_plain = cuda_time_ms(lambda: sparse_attention_ref(
        q, k, v, bias=bias, block_map=bmap, block_q=blk, block_k=blk, scale=scale),
        iters=3)
    k3_lib = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=scale), iters=5)
    k3_bound, k3_by, flops3, bytes3 = sparse_bound(q, v, bias, bmap, blk)
    log(f"time sparse_attention bf16 {tuple(q.shape)} block {blk}, served SVG map "
        f"({tile_shares(bmap)}): kernel {k3_ms:.4f} ms ({flops3 / k3_ms / 1e9:.2f} "
        f"TFLOP/s, {bytes3 / k3_ms / 1e6:.1f} GB/s), plain {k3_plain:.4f} ms, sdpa with "
        f"the f32 mask {k3_lib:.4f} ms, bound {k3_bound:.4f} ms ({k3_by}: "
        f"{flops3 / 1e12:.4f} TFLOP, {bytes3 / 1e9:.3f} GB)")
    del q, k, v, bias, bmap
    torch.cuda.empty_cache()
    q, k, v, bias, bmap = temporal_serving_call(serve_grid, 256)
    t_ms = cuda_time_ms(lambda: sparse_ops.sparse_attention(
        q, k, v, bias=bias, block_map=bmap, block_q=128, block_k=128))
    t_lib = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=scale), iters=5)
    t_bound, t_by, t_flops, t_bytes = sparse_bound(q, v, bias, bmap, 128)
    log(f"time sparse_attention bf16 {tuple(q.shape)} block 128, constructed "
        f"all-temporal map ({tile_shares(bmap)}): kernel {t_ms:.4f} ms "
        f"({t_flops / t_ms / 1e9:.2f} TFLOP/s, {t_bytes / t_ms / 1e6:.1f} GB/s), sdpa "
        f"with the f32 mask {t_lib:.4f} ms, bound {t_bound:.4f} ms ({t_by}: "
        f"{t_flops / 1e12:.4f} TFLOP, {t_bytes / 1e9:.3f} GB)")
    full = torch.full_like(bmap, FULL)
    f_ms = cuda_time_ms(lambda: sparse_ops.sparse_attention(
        q, k, v, block_map=full, block_q=128, block_k=128))
    f_lib = cuda_time_ms(lambda: sdpa(q, k, v, scale=scale))
    f_bound, f_by, f_flops, _ = sparse_bound(q, v, None, full, 128)
    log(f"time sparse_attention bf16 {tuple(q.shape)} block 128, all-FULL map: "
        f"kernel {f_ms:.4f} ms ({f_flops / f_ms / 1e9:.2f} TFLOP/s), sdpa {f_lib:.4f} "
        f"ms, bound {f_bound:.4f} ms ({f_by})")
    del q, k, v, bias, bmap, full
    torch.cuda.empty_cache()

    # 8. dit-xl2 at full width and depth, with the counters set to 0 just
    # before it and read just after ----------------------------------------
    counts_d = serve_dit()

    # 9. small trajectories, card vs CPU ------------------------------------
    small_reference_check("ripple")
    small_reference_check("svg", policy="svg")
    small_reference_check("ripple+svg", overrides=("ripple.svg_mask=true",))
    # The DiT at head dim 72 (d_model 144, 2 heads), 2 layers, grid (1, 4, 4).
    small_reference_check("dit-xl2", name="dit-xl2",
                          overrides=("model.d_model=144", "model.num_heads=2"))

    kernels = [
        {"name": "fused_reuse", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_reuse.cu",
         "replaces": "src/repro/kernels/reuse_mask/kernel.py:170",
         "launches": counts_r["fused_reuse"], "max_abs_err": serve_err1,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "ripple_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/ripple_attention.cu",
         "replaces": "src/repro/kernels/ripple/kernel.py:125",
         "launches": counts_r["ripple_attention"], "max_abs_err": serve_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib},
        {"name": "sparse_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/sparse_attention.cu",
         "replaces": "src/repro/kernels/sparse/kernel.py:120",
         "launches": counts_s["sparse_attention"], "max_abs_err": serve_err3,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib},
        # No single PyTorch call computes LayerNorm-and-modulate: the time
        # of F.layer_norm with its two elementwise ops is in the log line.
        {"name": "adaln", "route": "cuda",
         "source": "src/repro_torch/csrc/adaln.cu",
         "replaces": "src/repro/kernels/adaln/kernel.py:38",
         "launches": counts_d["adaln"], "max_abs_err": adaln_err,
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": None},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

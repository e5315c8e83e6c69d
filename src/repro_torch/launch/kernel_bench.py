"""Kernel micro-bench of the port: the kernel sections of the JAX
package's ``benchmarks/kernel_bench.py``, with the same row names and
fields, so that port and reference rows line up.

``python -m repro_torch.launch.kernel_bench`` runs on the CUDA card;
``--device cpu`` runs it on the CPU (kernel wrappers then take their
plain PyTorch versions, and the times are the CPU's).  Each section
takes the reference's default grid.

Sections:

* :func:`run` — on token-granularity reuse over correlated latents at
  the paper's 75 % / 85 % operating points: the paper-accounting savings
  (partial scores), the pair-collapse fractions, and the share of the
  reference's 128-pair block products its pair-collapse kernel skips, in
  x-major order, in t-major order (``pair_major_order``) and with the
  t-representatives protected (``compute_reuse(protect_axis="t")``);
* :func:`mask_pipeline_overhead` — the fused Δ-check kernel against the
  host ``compute_reuse`` at ``vdit_paper``'s full latent grid, as a
  modelled byte count and measured wall time;
* :func:`sparse_backend_sweep` — the svg policy's block map through the
  block-sparse kernel, the same kernel on an all-PARTIAL map, and the
  dense flash kernel (``dense_flash_us``) as the anchor.

The reference's other sections wait for their modules: the dispatch
autotune cache (``autotune_sweep``), the decision cache
(``decision_amortization``), offline patterns (``static_pattern_sweep``)
and ring attention (``ring_sweep``).
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.config.base import RippleConfig
from repro_torch.configs.vdit_paper import make_config
from repro_torch.core import savings as savings_lib
from repro_torch.core.collapse import pair_major_order
from repro_torch.core.dispatch import time_best
from repro_torch.core.policy import get_policy
from repro_torch.core.reuse import compute_reuse
from repro_torch.data.synthetic import correlated_video_latents
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.kernels.reuse_mask.ops import fused_compute_reuse
from repro_torch.kernels.ripple.ops import ripple_block_stats
from repro_torch.kernels.sparse.ops import (PARTIAL, sparse_attention,
                                            sparse_block_stats)
from repro_torch.utils.device import resolve_device

GRID = (8, 16, 16)
D = 64
AXES = ("t", "x", "y")


# --- the port's copy of the helpers of benchmarks/common.py ---------------


def savings_at(q, k, theta, grid=GRID, axes=AXES, window=2,
               granularity="channel"):
    th = {a: float(theta) for a in AXES}
    rq = compute_reuse(q, grid, th, axes=axes, window=window,
                       granularity=granularity)
    rk = compute_reuse(k, grid, th, axes=axes, window=window,
                       granularity=granularity)
    return float(savings_lib.partial_score_savings(rq.mask, rk.mask)), rq, rk


def theta_for_savings(q, k, target, grid=GRID, axes=AXES, window=2,
                      granularity="channel"):
    """The θ (same on every axis) whose savings reach ``target``: 28
    bisection steps on [0, 8]."""
    lo, hi = 0.0, 8.0
    for _ in range(28):
        mid = 0.5 * (lo + hi)
        s, _, _ = savings_at(q, k, mid, grid, axes, window, granularity)
        if s < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _qk(seed=0, *, grid=GRID, d=D, device="cuda"):
    """(1, 1, N, d) Q and K: correlated latents through random
    projections, as the reference's ``_qk``."""
    g = _generator(seed, device)
    lat = correlated_video_latents(g, 1, grid, d, temporal_rho=0.97,
                                   spatial_smooth=3)
    x = lat.reshape(1, 1, math.prod(grid), d)
    wq = 0.4 * torch.randn((d, d), generator=g, device=device)
    wk = 0.4 * torch.randn((d, d), generator=g, device=device)
    return x @ wq, x @ wk


# --- sections --------------------------------------------------------------


def run(q: Optional[torch.Tensor] = None, k: Optional[torch.Tensor] = None,
        *, grid: Tuple[int, int, int] = GRID, device="cuda"):
    """Rows at the 75 % and 85 % targets (token granularity); ``q`` / ``k``
    default to :func:`_qk` on ``device``."""
    if q is None:
        q, k = _qk(grid=grid, device=device)
    perm = torch.as_tensor(pair_major_order(grid, "t"), device=q.device)
    rows = []
    for target in (0.75, 0.85):
        theta = theta_for_savings(q, k, target, grid=grid,
                                  granularity="token")
        th = {a: theta for a in AXES}
        rq = compute_reuse(q, grid, th, granularity="token")
        rk = compute_reuse(k, grid, th, granularity="token")
        paper = float(savings_lib.partial_score_savings(rq.mask, rk.mask))
        pq, pk = savings_lib.pair_collapse_fractions(rq.mask, rk.mask)
        skip_raw = float(ripple_block_stats(rq.snapped, rk.snapped))
        skip_tmajor = float(ripple_block_stats(rq.snapped[..., perm, :],
                                               rk.snapped[..., perm, :]))
        # collapse-aware scheduling: protect t-representatives from x/y
        # snaps so the pair structure survives high thresholds
        rq_p = compute_reuse(q, grid, th, granularity="token",
                             protect_axis="t")
        rk_p = compute_reuse(k, grid, th, granularity="token",
                             protect_axis="t")
        paper_p = float(savings_lib.partial_score_savings(rq_p.mask,
                                                          rk_p.mask))
        skip_prot = float(ripple_block_stats(rq_p.snapped[..., perm, :],
                                             rk_p.snapped[..., perm, :]))
        rows.append({
            "target": target, "theta": round(theta, 4),
            "paper_savings": round(paper, 3),
            "pair_collapse_q": round(float(pq), 3),
            "pair_collapse_k": round(float(pk), 3),
            "mxu_block_skip_xmajor": round(skip_raw, 3),
            "mxu_block_skip_tmajor": round(skip_tmajor, 3),
            "paper_savings_protected": round(paper_p, 3),
            "mxu_block_skip_protected": round(skip_prot, 3),
        })
    return rows


def mask_pipeline_overhead(grid=None, d=128, theta=0.35, *, device="cuda"):
    """The fused Δ-check kernel against the unfused host path at the
    paper's ``vdit_paper`` shape (one head).

    Byte model: the fused kernel touches the operand once — one read plus
    the snapped and mask writes.  The host path runs one windowed pass
    per grid axis (read x, write a per-token representative and a mask)
    and a combine pass that re-reads x and the three (rep, mask) pairs to
    write snapped and mask.
    """
    if grid is None:
        grid = make_config().model.grid()  # (32, 32, 32) at 512 res
    lat = correlated_video_latents(_generator(0, device), 1, grid, d,
                                   temporal_rho=0.95, spatial_smooth=2)
    x = lat.reshape(1, 1, math.prod(grid), d)
    th = {a: theta for a in AXES}

    def host():
        r = compute_reuse(x, grid, th)
        return r.snapped, r.mask

    host_us = time_best(host, repeats=5) * 1e6
    fused_us = time_best(lambda: fused_compute_reuse(x, grid, th),
                         repeats=5) * 1e6

    e = x.element_size()
    elems = x.numel()
    fused_bytes = elems * (e + e + 1)               # read x, write snap+mask
    axis_pass = elems * (e + e + 1)                 # read x, write rep+mask
    combine = elems * (e + 3 * (e + 1) + e + 1)     # read x+3(rep,mask); write
    host_bytes = 3 * axis_pass + combine
    return {
        "grid": tuple(grid), "d": d,
        "fused_mask_bytes": fused_bytes,
        "host_mask_bytes": host_bytes,
        "bytes_ratio": round(fused_bytes / host_bytes, 3),
        "fused_mask_us": round(fused_us, 1),
        "host_mask_us": round(host_us, 1),
        "walltime_ratio": round(fused_us / max(host_us, 1e-9), 3),
        "fused_le_host": fused_bytes <= host_bytes,
    }


def sparse_backend_sweep(grid=None, d=64, heads=2, block=128, *,
                         device="cuda"):
    """The svg policy's block map through the block-sparse kernel at a
    ``vdit_paper``-style latent grid (default (8, 16, 16): 32 frames at
    256²), float32 as in the reference:

      * ``skip_rate`` — the share of (q, k) tiles the kernel skips;
      * ``modeled_attn_speedup`` — 1 / (1 − skip_rate);
      * ``walltime_speedup`` — the same kernel on an all-PARTIAL map
        against the real map;
      * ``dense_flash_us`` — the dense flash kernel as the anchor.
    """
    if grid is None:
        grid = make_config().model.grid(frames=32, img_res=256)
    n = math.prod(grid)
    lat = correlated_video_latents(_generator(11, device), heads, grid, d,
                                   temporal_rho=0.95, spatial_smooth=2)
    x = lat.reshape(1, heads, n, d)
    wq = 0.4 * torch.randn((d, d), generator=_generator(12, device),
                           device=device)
    wk = 0.4 * torch.randn((d, d), generator=_generator(13, device),
                           device=device)
    q, k = x @ wq, x @ wk
    v = torch.randn((1, heads, n, d), generator=_generator(14, device),
                    device=device)
    del lat, x

    pol = get_policy("svg")
    cfg = RippleConfig(enabled=True)
    dec = pol.decide(q, k, grid=grid, cfg=cfg,
                     thetas=pol.thetas_for(cfg, 0, 1),
                     block_shape=(block, block))
    skip = float(sparse_block_stats(dec.block_map))

    def sparse(bmap):
        return sparse_attention(q, k, v, bias=dec.bias, block_map=bmap,
                                block_q=block, block_k=block)

    dense_map = torch.full_like(dec.block_map, PARTIAL)
    sparse_us = time_best(lambda: sparse(dec.block_map), repeats=2) * 1e6
    dense_map_us = time_best(lambda: sparse(dense_map), repeats=2) * 1e6
    flash_us = time_best(lambda: flash_attention(q, k, v, block_q=block,
                                                 block_k=block),
                         repeats=2) * 1e6
    return {
        "grid": tuple(grid), "d": d, "heads": heads, "block": block,
        "mask_savings": round(float(dec.savings), 3),
        "skip_rate": round(skip, 3),
        "modeled_attn_speedup": round(1.0 / max(1.0 - skip, 1e-9), 2),
        "sparse_us": round(sparse_us, 1),
        "dense_map_us": round(dense_map_us, 1),
        "dense_flash_us": round(flash_us, 1),
        "walltime_speedup": round(dense_map_us / max(sparse_us, 1e-9), 2),
    }


# --- entry point -------------------------------------------------------------


def _gname(g) -> str:
    # no commas: a row's first two fields stay structural for parsers
    return "x".join(str(v) for v in g)


def sparse_row(s) -> str:
    return (f"kernel_bench[sparse@vdit_paper{_gname(s['grid'])}xd{s['d']}],"
            f"{s['sparse_us']:.0f},"
            f"skip_rate={s['skip_rate']};"
            f"mask_savings={s['mask_savings']};"
            f"modeled_attn_speedup={s['modeled_attn_speedup']};"
            f"sparse_us={s['sparse_us']};dense_map_us={s['dense_map_us']};"
            f"dense_flash_us={s['dense_flash_us']};"
            f"walltime_speedup={s['walltime_speedup']}")


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    rows = run(device=device)
    us = (time.perf_counter() - t0) * 1e6
    for r in rows:
        print(f"kernel_bench[{int(r['target']*100)}%],{us:.0f},"
              f"paper={r['paper_savings']};"
              f"collapse_q={r['pair_collapse_q']};"
              f"collapse_k={r['pair_collapse_k']};"
              f"mxu_skip_x={r['mxu_block_skip_xmajor']};"
              f"mxu_skip_t={r['mxu_block_skip_tmajor']};"
              f"protected:paper={r['paper_savings_protected']},"
              f"mxu_skip={r['mxu_block_skip_protected']}", flush=True)

    m = mask_pipeline_overhead(device=device)
    print(f"kernel_bench[mask_fusion@vdit_paper{_gname(m['grid'])}xd{m['d']}],"
          f"{m['fused_mask_us']:.0f},"
          f"fused_bytes={m['fused_mask_bytes']};"
          f"host_bytes={m['host_mask_bytes']};"
          f"bytes_ratio={m['bytes_ratio']};"
          f"fused_us={m['fused_mask_us']};host_us={m['host_mask_us']};"
          f"walltime_ratio={m['walltime_ratio']};"
          f"fused_le_host={m['fused_le_host']}", flush=True)

    s = sparse_backend_sweep(device=device)
    print(sparse_row(s), flush=True)
    return rows + [m, s]


if __name__ == "__main__":
    main()

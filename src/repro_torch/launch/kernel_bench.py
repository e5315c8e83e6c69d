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
  dense flash kernel (``dense_flash_us``) as the anchor;
* :func:`decision_amortization` — the cross-step decision cache: one
  decision against one re-application of a cached plan, per
  cache-capable policy, and the per-step decision overhead at cadences
  R = 1, 2, 4, 8;
* :func:`static_pattern_sweep` — searched static patterns against
  adaptive ripple: the per-step replay cost of each, the block map's
  stability over the schedule, and the output quality of each at the
  same savings;
* :func:`ring_sweep` — context-parallel ring attention (DESIGN.md §14)
  under a ``1x1xS`` mesh: the ring hops whose block-map slice is
  all-SKIP, so the shard skips the hop's kernel launch.  Skipped, with
  a log line, when no ring mesh can be built (fewer than two visible
  devices: ``REPRO_TORCH_FORCE_DEVICE_COUNT``, ``launch/mesh.py``).

The reference's dispatch autotune cache (``autotune_sweep``) is not
ported: the port's plans take fixed tiles.
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


def _decision_tensors(d):
    """The tensors of a ReuseDecision an attention backend would read."""
    return tuple(t for t in (d.q, d.k, d.bias, d.block_map) if t is not None)


def _consume(d):
    """Each tensor the backend would read, reduced to a scalar."""
    return tuple(t.sum() for t in _decision_tensors(d))


def decision_amortization(grid=None, d=64, heads=2, cadences=(1, 2, 4, 8),
                          *, device="cuda"):
    """Per-step decision overhead of the cross-step decision cache at a
    ``vdit_paper``-style latent grid, for each cache-capable policy:

      * ``decide_us`` — one ``decide(want_plan=True)`` (the Δ-checks and
        their source maps, or the head classification and mask building),
      * ``apply_us`` — one ``apply_decision`` on fresh operands (a gather
        for ripple, the cached bias and map attached for svg),

    each followed by a sum over every tensor the backend would read, less
    the time of those sums alone on a decision made beforehand (the
    consumer floor).  The per-step overhead at cadence R is
    ``(decide + (R-1)·apply) / R`` and ``reduction`` its gain over R=1.
    """
    from repro_torch.core import decision_cache as dc

    if grid is None:
        grid = make_config().model.grid(frames=32, img_res=256)  # (8,16,16)
    n = math.prod(grid)
    lat = correlated_video_latents(_generator(21, device), heads, grid, d,
                                   temporal_rho=0.95, spatial_smooth=2)
    x = lat.reshape(1, heads, n, d)
    wq = 0.4 * torch.randn((d, d), generator=_generator(22, device),
                           device=device)
    wk = 0.4 * torch.randn((d, d), generator=_generator(23, device),
                           device=device)
    q, k = x @ wq, x @ wk
    rows = []
    for name in ("ripple", "svg"):
        pol = get_policy(name)
        cfg = RippleConfig(enabled=True, policy=name, theta_min=0.2,
                           theta_max=0.5, i_min=2, i_max=8)
        thetas = pol.thetas_for(cfg, 5, 10)
        extra = {"block_shape": (128, 128)} if name == "svg" else {}

        def decide():
            return _consume(pol.decide(q, k, grid=grid, cfg=cfg,
                                       thetas=thetas, fused=q.is_cuda,
                                       want_plan=True, **extra))

        d0 = pol.decide(q, k, grid=grid, cfg=cfg, thetas=thetas,
                        fused=q.is_cuda, want_plan=True, **extra)
        cache = dc.cache_from_decision(d0, dc.drift_stat(q, k, cfg))

        def apply():
            return _consume(pol.apply_decision(q, k, cache, grid=grid,
                                               cfg=cfg, thetas=thetas))

        floor_us = time_best(lambda: _consume(d0), repeats=5) * 1e6
        decide_us = max(time_best(decide, repeats=5) * 1e6 - floor_us, 0.0)
        apply_us = max(time_best(apply, repeats=5) * 1e6 - floor_us, 0.0)
        per_step = {R: (decide_us + (R - 1) * apply_us) / R for R in cadences}
        rows.append({
            "policy": name, "grid": tuple(grid), "d": d, "heads": heads,
            "decide_us": round(decide_us, 1),
            "apply_us": round(apply_us, 1),
            "per_step_us": {R: round(us, 1) for R, us in per_step.items()},
            "reduction": {R: round(per_step[1] / max(us, 1e-9), 2)
                          for R, us in per_step.items()},
        })
    return rows


def ring_sweep(grid=None, d=64, heads=2, policy="svg", steps=2, seq=None,
               *, device="cuda"):
    """Context-parallel ring attention (DESIGN.md §14) at a vdit_paper
    style latent grid, the reference's ``ring_sweep``: ``steps`` cached
    dispatch calls under a ``1x1xS`` mesh (the active dispatch mesh when
    it has a ``seq`` axis, else one over the visible devices), reading
    the ring's telemetry off the carried decision state:

      * ``elided_hops`` — ring hops whose block-map slice was all-SKIP
        (the shard skipped the hop's kernel launch),
      * ``hops`` — every hop (steps × S shards × S hops),
      * ``elided_frac`` — the realized structural saving; the K/V
        rotation still runs every hop, so the matching communication
        saving is modelled, not realized.

    Returns None when no ring mesh can be built (one visible device, or
    the seq degree does not divide the frame axis)."""
    from repro_torch.core import dispatch as dispatch_lib
    from repro_torch.launch.mesh import parse_mesh_spec, visible_devices

    device = resolve_device(device)
    if grid is None:
        grid = make_config().model.grid(frames=32, img_res=256)  # (8,16,16)
    mesh = dispatch_lib.active_dispatch_mesh()
    if mesh is None or "seq" not in mesh.axis_names \
            or int(mesh.shape["seq"]) < 2:
        if seq is None:
            n_dev = len(visible_devices(device))
            seq = max((s for s in (8, 4, 2)
                       if s <= n_dev and grid[0] % s == 0), default=1)
        if seq < 2:
            return None
        mesh = parse_mesh_spec(f"1x1x{seq}", device=device)
    S = int(mesh.shape["seq"])
    if grid[0] % S:
        return None

    n = grid[0] * grid[1] * grid[2]
    # Random operands: uncorrelated data classifies every head spatial
    # (the 2/T-vs-3/HW margin, DESIGN.md §12), whose local + sink mask is
    # what makes whole ring hops elidable.
    q, k, v = (torch.randn((1, heads, n, d), generator=_generator(31 + i,
                                                                   device),
                           device=device) for i in range(3))
    cfg = RippleConfig(enabled=True, policy=policy, reuse_every=2)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with dispatch_lib.dispatch_mesh(mesh):
        plan = dispatch_lib.resolve_plan(q.shape, v.shape, cfg,
                                         on_cuda=device.type == "cuda",
                                         backend="sparse", policy=policy,
                                         grid=grid)

        def step_fn(step, state):
            return dispatch_lib.attention_dispatch(
                q, k, v, grid=grid, cfg=cfg, step=step,
                total_steps=steps + 1, backend="sparse", policy=policy,
                cached_decision=state, return_decision=True)

        # A warm-up call outside the timed loop; its state is dropped so
        # the elided counters cover the timed steps only.
        step_fn(0, None)
        sync()
        state = None
        t0 = time.perf_counter()
        for s in range(steps):
            out, state = step_fn(s, state)
        sync()
        us = (time.perf_counter() - t0) * 1e6 / steps

    elided = 0 if state.elided is None else int(state.elided.sum())
    hops = steps * S * S
    frac = elided / hops
    return {
        "grid": grid, "d": d, "heads": heads, "policy": policy,
        "seq": S, "steps": steps, "ring": plan.seq_shards == S,
        "elided_hops": elided, "hops": hops,
        "elided_frac": round(frac, 3),
        "modeled_attn_speedup": round(1.0 / max(1.0 - frac, 1e-9), 2),
        "us_per_step": round(us, 1),
    }


def static_pattern_sweep(grid=None, d=64, heads=2, steps=4, *,
                         device="cuda"):
    """Searched static patterns (DESIGN.md §16) against adaptive ripple at
    a ``vdit_paper``-style latent grid (default (8, 16, 16)).

    Runs the offline pattern search in-process on small head-diverse
    calibration traffic, installs the artifact, and reports:

      * ``apply_ratio`` — the static policy's per-step ``apply_decision``
        cost over ripple's, each followed by a sum over every tensor the
        backend would read, less the time of those sums alone (the
        consumer floor, as in :func:`decision_amortization`).  Static
        replay is a passthrough (no snap gather);
      * ``map_stable`` — the block map decided at step 0 against the last
        step's, bitwise (a static plan must not drift with the schedule);
      * ``psnr_static`` / ``psnr_ripple`` / ``psnr_delta_db`` — output
        PSNR against dense attention of the static pattern and of ripple
        at a θ matched to the same savings;
      * ``skip_rate`` — the skipped-tile share of the searched patterns'
        block map.
    """
    from repro_torch.core import decision_cache as dc
    from repro_torch.core import dispatch as dispatch_lib
    from repro_torch.core import patterns
    from repro_torch.launch.pattern_search import calibration_traffic

    if grid is None:
        grid = make_config().model.grid(frames=32, img_res=256)  # (8,16,16)
    blocks = (128, 128)
    # one layer of head-diverse calibration traffic, searched in-process
    samples = calibration_traffic(grid=grid, layers=1, heads=heads, steps=2,
                                  prompts=1, d=d,
                                  characters=("temporal", "spatial"),
                                  device=device)
    art = patterns.search_patterns(samples, grid, block_shape=blocks,
                                   tolerance_db=20.0,
                                   meta={"traffic": "bench"})
    # held-out eval traffic: the same head characters, another seed
    _, q, k, v = next(iter(calibration_traffic(
        grid=grid, layers=1, heads=heads, steps=1, prompts=1, d=d, seed=123,
        characters=("temporal", "spatial"), device=device)))

    with patterns.use_artifact(art):
        # --- per-step replay cost, static vs ripple -------------------
        apply_us = {}
        for name in ("static", "ripple"):
            pol = get_policy(name)
            cfg = RippleConfig(enabled=True, policy=name, theta_min=0.2,
                               theta_max=0.5, i_min=1, i_max=steps - 1)
            thetas = pol.thetas_for(cfg, 1, steps)
            extra = {"block_shape": blocks} if name == "static" else {}
            d0 = pol.decide(q, k, grid=grid, cfg=cfg, thetas=thetas,
                            fused=q.is_cuda, want_plan=True, **extra)
            cache = dc.cache_from_decision(d0, dc.drift_stat(q, k, cfg))

            def apply(pol=pol, cfg=cfg, thetas=thetas, cache=cache,
                      extra=extra):
                return _consume(pol.apply_decision(q, k, cache, grid=grid,
                                                   cfg=cfg, thetas=thetas,
                                                   **extra))

            # Interleaved floor/apply rounds, the smallest difference
            # kept: drift common to a round cancels.
            diffs = []
            for _ in range(5):
                f = time_best(lambda d0=d0: _consume(d0), repeats=10)
                a = time_best(apply, repeats=10)
                diffs.append(a - f)
            apply_us[name] = max(min(diffs) * 1e6, 0.0)

        # --- block-map stability across the schedule ------------------
        pol = get_policy("static")
        cfg_s = RippleConfig(enabled=True, policy="static", theta_min=0.2,
                             theta_max=0.5, i_min=1, i_max=steps - 1)
        maps = [pol.decide(q, k, grid=grid, cfg=cfg_s,
                           thetas=pol.thetas_for(cfg_s, s, steps),
                           block_shape=blocks).block_map
                for s in (0, steps - 1)]
        stable = bool(torch.equal(maps[0], maps[1]))
        skip = float(sparse_block_stats(maps[0]))

        # --- quality at matched savings -------------------------------
        dense = dispatch_lib.attention_dispatch(
            q, k, v, grid=grid, cfg=RippleConfig(enabled=False),
            backend="dense").cpu().numpy()
        out_s = dispatch_lib.attention_dispatch(q, k, v, grid=grid, cfg=cfg_s,
                                                step=1, total_steps=steps)
        target = float(pol.decide(q, k, grid=grid, cfg=cfg_s,
                                  thetas=pol.thetas_for(cfg_s, 1, steps),
                                  block_shape=blocks).savings)
        theta = theta_for_savings(q, k, target, grid=grid)
        cfg_r = RippleConfig(enabled=True, policy="ripple", theta_min=theta,
                             theta_max=theta, i_min=1, i_max=steps - 1)
        out_r = dispatch_lib.attention_dispatch(q, k, v, grid=grid,
                                                cfg=cfg_r, step=1,
                                                total_steps=steps)

    def psnr(ref, out):
        mse = float(((ref - out.cpu().numpy()) ** 2).mean())
        rng = float(ref.max() - ref.min())
        return 10 * math.log10(rng ** 2 / max(mse, 1e-12))

    p_s, p_r = psnr(dense, out_s), psnr(dense, out_r)
    return {
        "grid": tuple(grid), "d": d, "heads": heads,
        "static_frac": round(art.static_fraction(), 3),
        "skip_rate": round(skip, 3),
        "matched_savings": round(target, 3),
        "static_apply_us": round(apply_us["static"], 1),
        "ripple_apply_us": round(apply_us["ripple"], 1),
        "apply_ratio": round(apply_us["static"]
                             / max(apply_us["ripple"], 1e-9), 3),
        "map_stable": stable,
        "psnr_static": round(p_s, 1),
        "psnr_ripple": round(p_r, 1),
        "psnr_delta_db": round(p_r - p_s, 2),
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


def amortization_row(r) -> str:
    per = ";".join(f"R{R}={us}" for R, us in r["per_step_us"].items())
    red = ";".join(f"red_R{R}={x}" for R, x in r["reduction"].items())
    return (f"kernel_bench[decision_amortization@vdit_paper"
            f"{_gname(r['grid'])}xd{r['d']}/{r['policy']}],"
            f"{r['decide_us']:.0f},"
            f"decide_us={r['decide_us']};apply_us={r['apply_us']};"
            f"{per};{red}")


def ring_row(r) -> str:
    return (f"kernel_bench[ring@{r['policy']}x{r['seq']}seq"
            f"_vdit_paper{_gname(r['grid'])}xd{r['d']}],"
            f"{r['us_per_step']:.0f},"
            f"elided_hops={r['elided_hops']};hops={r['hops']};"
            f"elided_frac={r['elided_frac']};"
            f"modeled_attn_speedup={r['modeled_attn_speedup']};"
            f"ring={r['ring']};steps={r['steps']}")


def static_pattern_row(sp) -> str:
    return (f"kernel_bench[static_pattern@vdit_paper"
            f"{_gname(sp['grid'])}xd{sp['d']}],"
            f"{sp['static_apply_us']:.0f},"
            f"apply_ratio={sp['apply_ratio']};"
            f"static_apply_us={sp['static_apply_us']};"
            f"ripple_apply_us={sp['ripple_apply_us']};"
            f"skip_rate={sp['skip_rate']};"
            f"static_frac={sp['static_frac']};"
            f"map_stable={sp['map_stable']};"
            f"matched_savings={sp['matched_savings']};"
            f"psnr_static={sp['psnr_static']};"
            f"psnr_ripple={sp['psnr_ripple']};"
            f"psnr_delta_db={sp['psnr_delta_db']}")


@torch.no_grad()
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

    amort = decision_amortization(device=device)
    for r in amort:
        print(amortization_row(r), flush=True)

    sp = static_pattern_sweep(device=device)
    print(static_pattern_row(sp), flush=True)

    ring = ring_sweep(device=device)
    if ring is None:
        print("# ring_sweep skipped: needs 2+ visible devices and seq | "
              "frames (set REPRO_TORCH_FORCE_DEVICE_COUNT=N)", flush=True)
    else:
        print(ring_row(ring), flush=True)
    return rows + [m, s] + amort + [sp] + ([ring] if ring else [])


if __name__ == "__main__":
    main()

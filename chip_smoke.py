#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. builds the port's CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc for sm_90a (one nvcc per source, started together);
2. holds the fused Δ-check + snap kernel bit for bit against its plain
   version (``core.reuse.compute_reuse``), bf16 and f32, channel and
   token gates, at the serving shape, a small shape and T = 1;
3. holds the pair-collapse attention kernel against f32 dense softmax on
   the same snapped operands, on constructed operands with collapse
   fractions 0, 0.6 and 1.0, an unaligned N and the serving shape;
4. times both kernels, their plain versions and (attention only)
   ``scaled_dot_product_attention`` with CUDA events;
5. serves 3 requests of vdit-paper at full width through the port's
   DiffusionEngine, counting kernel launches, then checks the output and
   a small trajectory on the card against the same trajectory on the CPU.

It prints the card's name and power limit, one JSON line describing the
kernels, and as its last line ``{"ok": true, "device": {...}}``.  Any
mismatch or error exits non-zero.  It needs one card and no network.
``--layers N`` cuts the served depth (default: all 40 layers).
"""

from __future__ import annotations

import argparse
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
    import torch
    from repro_torch.kernels.ripple import ops as ripple_ops

    out = ripple_ops.ripple_attention(q, k, v)
    tc = ripple_ops.uses_tensor_cores(q, v)
    ref = attention_oracle(q, k, v, ripple_ops.attention_scale(q.shape[-1]),
                           tc)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    name = str(q.dtype).replace("torch.", "")
    qf, kf, _ = ripple_ops.ripple_tile_stats(q, k, v.shape[-1])
    tol = attn_tol(name, ref)
    ok = err <= tol and bool(torch.isfinite(out).all())
    path = "tensor cores" if tc else "CUDA cores"
    log(f"kernel ripple_attention {name:8s} {label} [{path}]: q tiles collapsed "
        f"{qf:.3f}, k tiles collapsed {kf:.3f}, max abs err vs f32 dense "
        f"{err:.3e} (tol {tol:.3g}) {'ok' if ok else 'FAIL'}")
    results.append(ok)
    if not ok:
        raise SystemExit("ripple kernel disagrees with dense attention")
    return err


# ---------------------------------------------------------------------------
# Serving phase
# ---------------------------------------------------------------------------


def serve(layers: int):
    import numpy as np
    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_sampler, serving_shape
    from repro_torch.launch.workloads import mixed_request_stream
    from repro_torch.models.params import init_vdit
    from repro_torch.serving.engine import DiffusionEngine

    arch = apply_overrides(get_config("vdit-paper"),
                           SERVE_OVERRIDES + (f"model.num_layers={layers}",))
    shape = serving_shape(arch, "gen_512", smoke=False, steps=SERVE_STEPS)
    m = arch.model
    grid = m.grid(img_res=shape.img_res)
    log(f"serve: vdit-paper full width d_model={m.d_model} heads="
        f"{m.num_heads}x{m.d_model // m.num_heads} mlp={int(m.d_model * m.mlp_ratio)} "
        f"text={m.txt_tokens}x{m.txt_dim} axes={m.axes_dim}; cuts: frames "
        f"128->{m.frames} (grid {grid}, {grid[0] * grid[1] * grid[2] + m.txt_tokens} "
        f"tokens), layers 40->{m.num_layers}, {SERVE_STEPS} DDIM steps; "
        f"ripple {arch.ripple}")
    t0 = time.perf_counter()
    model = init_vdit(m, seed=0, device="cuda", dtype=torch.bfloat16,
                      zero_init=False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: {n_params / 1e9:.3f} B params (bf16, every leaf drawn from "
        f"a seeded generator at fan-in scale) in {time.perf_counter() - t0:.1f}s")
    sample_fn, lat_shape = build_sampler(arch, shape, model)

    # The policy's snap masks at step 10, read by shadowing the registered
    # policy's methods on its instance for this run only.
    pol = get_policy(arch.ripple.policy)
    snaps = {"q": [], "k": []}
    current = {"step": None}

    def thetas_for(cfg, step, total_steps, thetas=None):
        current["step"] = step
        return type(pol).thetas_for(pol, cfg, step, total_steps, thetas)

    def decide(q, k, **kw):
        d = type(pol).decide(pol, q, k, **kw)
        if current["step"] == 10:
            s, n = kw["grid_slice"]
            snaps["q"].append(d.q_mask.narrow(-2, s, n).float().mean())
            snaps["k"].append(d.k_mask.narrow(-2, s, n).float().mean())
        return d

    engine = DiffusionEngine(lambda shp, steps: sample_fn, device="cuda",
                             max_batch=SERVE_REQUESTS)
    traffic = mixed_request_stream(arch, (shape,), SERVE_REQUESTS, seed=0)
    pol.thetas_for, pol.decide = thetas_for, decide
    torch.cuda.synchronize()
    reset_launch_counts()
    engine.start()
    try:
        for _, req in traffic:
            engine.submit(req)
        results = [engine.result(req.request_id) for _, req in traffic]
    finally:
        engine.stop()
        del pol.thetas_for, pol.decide
    torch.cuda.synchronize()
    counts = launch_counts()
    for r in results:
        log(f"serve: request {r.request_id} latency {r.latency_s:.3f}s "
            f"(batch {r.batch_index} of {SERVE_REQUESTS} served in "
            f"{r.walltime_s:.3f}s); latents {r.latents.shape}")
        if r.latents.shape != lat_shape:
            raise SystemExit(f"latents {r.latents.shape} != {lat_shape}")
        if not np.isfinite(r.latents).all():
            raise SystemExit("served latents are not finite")
    q_snap = torch.stack(snaps["q"]).mean().item() if snaps["q"] else 0.0
    k_snap = torch.stack(snaps["k"]).mean().item() if snaps["k"] else 0.0
    log(f"serve: launches {counts}; snap fraction at step 10: Q {q_snap:.4f} "
        f"K {k_snap:.4f}")
    if min(counts.values()) <= 0:
        raise SystemExit(f"a kernel of the main path never launched: {counts}")
    if q_snap <= 0 or k_snap <= 0:
        raise SystemExit("no snapping at step 10")
    profile_forward(arch, model, lat_shape)
    del model
    torch.cuda.empty_cache()
    return counts, results


def profile_forward(arch, model, lat_shape):
    """Device time by kernel family over one served-size denoiser forward
    (batch of 3, step 10 of 12: snapping on), from torch.profiler, and the
    device's idle share of that forward's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.workloads import _denoise_call

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.randn((SERVE_REQUESTS, *lat_shape), generator=g, device="cuda")
    txt = 0.05 * torch.randn((SERVE_REQUESTS, arch.model.txt_tokens,
                              arch.model.txt_dim), generator=g, device="cuda")
    t = torch.full((SERVE_REQUESTS,), 200.0, device="cuda")

    def fwd():
        return _denoise_call(arch, model, x, t, {"txt": txt}, 10, SERVE_STEPS)

    fwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {"ripple_attention": 0.0, "fused_reuse": 0.0, "gemm": 0.0,
           "other": 0.0}
    spans = []
    for ev in prof.events():  # device-side activities only (kernels, copies)
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        us = ev.time_range.elapsed_us()
        name = ev.name.lower()
        if "ripple" in name:
            fam["ripple_attention"] += us
        elif "fused_reuse" in name:
            fam["fused_reuse"] += us
        elif "gemm" in name or "cutlass" in name or "xmma" in name \
                or "nvjet" in name:
            fam["gemm"] += us
        else:
            fam["other"] += us
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
        log("profile: the profiler reported no device time")
        return
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in fam.items())
    log(f"profile: one forward, batch {SERVE_REQUESTS}, "
        f"{arch.model.num_layers} layers, step 10: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms (sum of events {sum_ms:.3f} ms; idle "
        f"share {1 - busy_ms / wall_ms:.4f}); {parts}")
    if sum_ms > 1.01 * busy_ms or busy_ms > wall_ms:
        raise SystemExit("profile: device time exceeds its span or the wall "
                         "time; the reading is not usable")


def small_reference_check():
    """The smoke config's 12-step trajectory in f32 through the kernels on
    the card against the same trajectory through the plain versions on
    the CPU, same params and noise."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import build_sampler, serving_shape
    from repro_torch.models.params import init_vdit
    from repro_torch.serving.engine import request_noise

    arch = get_smoke_config("vdit-paper")
    shape = serving_shape(arch, "gen_512", smoke=True, steps=SERVE_STEPS)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = init_vdit(arch.model, seed=1, device="cpu", zero_init=False)
        model = model.to(dev)
        fn, lat_shape = build_sampler(arch, shape, model,
                                      compute_dtype=torch.float32)
        noise = request_noise(5, lat_shape, "cpu")[None].to(dev)
        txt = torch.from_numpy(0.05 * np.random.default_rng(5).standard_normal(
            (1, arch.model.txt_tokens, arch.model.txt_dim)).astype(
                np.float32)).to(dev)
        outs[dev] = fn(noise, txt).float().cpu()
    diff = (outs["cuda"] - outs["cpu"]).norm() / outs["cpu"].norm()
    ok = bool(torch.isfinite(outs["cuda"]).all()) and diff.item() < 1e-3
    log(f"reference: smoke 12-step f32 trajectory, card kernels vs CPU plain "
        f"versions: relative L2 {diff.item():.3e} (tol 1e-3) "
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

    card = card_line()
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
        for d in (16, 32):
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
    log(f"kernel ripple_attention: {sum(res2)}/{len(res2)} cases within "
        f"tolerance")

    # 4. times at the serving shape (bf16) ----------------------------------
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
    torch.cuda.empty_cache()

    # 5. serving phase --------------------------------------------------------
    counts, _ = serve(args.layers)
    small_reference_check()

    kernels = [
        {"name": "fused_reuse", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_reuse.cu",
         "replaces": "src/repro/kernels/reuse_mask/kernel.py:170",
         "launches": counts["fused_reuse"], "max_abs_err": serve_err1,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "ripple_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/ripple_attention.cu",
         "replaces": "src/repro/kernels/ripple/kernel.py:125",
         "launches": counts["ripple_attention"], "max_abs_err": serve_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. builds the port's CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc for sm_90a (one nvcc per source, started together);
2. holds the fused Δ-check + snap kernel bit for bit against its plain
   version (``core.reuse.compute_reuse`` on the grid tokens, text tokens
   passed through), bf16 and f32, channel and token gates, at the vDiT
   serving shape, small shapes, T = 1, the DiT's T = 1 x/y case at head
   dim 72, views read in place (transposed, channel windows, unaligned)
   with text tokens around the grid, d 72 and 128 and the scalar
   instance (bf16 d 36, f32 d 6), unet-sd15's four self-attention calls
   (d 40, 80, 160, T = 1), ``serve[launcher]``'s half-resolution bucket
   ((2, 24, 2048, 128) grid tokens on (8, 16, 16) after 256 text
   tokens); the channel gate at every θ the
   served schedules give (each bf16 value from 0.2 to 0.5, the schedules'
   float32 values) and at 0, denormals, 1.0 and inf; then
   ``core.policy.snap_operand`` at the vDiT's served call through the
   kernel against the host pipeline; and the kernel's snap-source map
   (``want_src``, the decision cache's refresh step) bit for bit against
   ``compute_reuse(want_src=True)``, gathering by it equal to the
   snapped values (served call, the DiT's, the token gate, the scalar
   instance, f32 and bf16);
3. holds the pair-collapse attention kernel against f32 dense softmax on
   the same snapped operands, on constructed operands with collapse
   fractions 0, 0.6 and 1.0, an unaligned N, head dims 16 to 128 (72 on
   tensor cores, asserted), B*H > 1 with a ragged last tile at d 128 and
   72, all-collapsed keys under dense queries and the other way round,
   and both serving shapes and ``serve[launcher]``'s half-resolution
   bucket (2, 24, 2304, 128); the same cases at unet-sd15's head dims 40,
   80 and 160 (tensor cores, asserted) and its four served shapes, and
   the CUDA cores at d 160 and 256;
4. holds the fused adaLN modulation kernel against its plain version,
   bf16 and f32, d 72 and 1152, ragged N, B > 1 with a different shift
   and scale per sample, and shift/scale read in place from chunks of the
   adaLN projection;
5. holds the block-sparse attention kernel against its plain semantics
   (f32, rounding where the kernel rounds) on all-FULL maps (and against
   ``scaled_dot_product_attention``), all-SKIP maps (exact zeros), mixed
   maps with -inf and finite PARTIAL biases, fully skipped rows, ragged
   and clamped N, a PARTIAL-heavy map under a bias broadcast over batch
   and heads, map rows live only at their two ends (the ring wraps, with
   and without a bias), an SVG map at the serving shape, and a
   constructed all-temporal map at batch 2 whose batch rows carry
   different biases; each case logs the path it took; then the same
   kinds of case at unet-sd15's head dims 40, 80 and 160 (tensor cores,
   asserted), the CUDA cores at d 160 and 256, and the UNet's four served
   calls all-FULL and on a constructed spatial_local map with its bias;
5a. the dispatch mesh, kernel side: ``sparse[carry]`` (the sparse
   kernel's ring carry on both paths at (1, 24, 8192, 128), spatial and
   temporal heads: chains of 2, 4 and 8 hops over whole key tiles bit
   for bit one call, output and state; held to the oracle and the plain
   version; a fully masked row zeros; all-SKIP hops not launched; one
   call and a chain of 4 timed by device time beside SDPA), then
   ``ring[svg]`` and ``ring[ripple]`` (``attention_dispatch`` at that
   shape on grid (8, 32, 32), unsharded and on 2 and 4 seq shards of the
   one card: svg within the bf16 bar, its elided hops counted from the
   unsharded block map, shards x hops - elided sparse launches; ripple
   bit for bit), the port's kernel-bench ring section on 8 shards, and
   with more than one card ``ring[svg]`` one shard a card;
5b. holds the dense flash attention kernel against f32 dense softmax
   (rounding p where the bf16 kernel rounds it) on the reference tests'
   four shapes (d != dv, Nq != Nk, unaligned), odd head dims, a ragged
   Nq != Nk with d != dv, extreme
   logits and both serving shapes, f32 on CUDA cores and bf16 on tensor
   cores; head dims above 128 (slice 17): d 192, d 256, d 256 with dv
   128 and d 130 with dv 250, ragged Nq != Nk, both paths, and gemma3-4b's
   global-layer head shape (1, 8, 4096, 256) in bf16 (timed in 6 beside
   SDPA and its bound); and the single-axis pair-snap kernel bit for bit
   against its plain version (the reference tests' cases, bf16 and f32,
   and the vDiT serving shape);
6. times the kernels at the shapes their paths give them (ripple also
   as a factor of SDPA's time and a share of its bound), their plain
   versions and, for attention, ``scaled_dot_product_attention`` (for
   adaLN, ``F.layer_norm`` and its two elementwise ops, and for the pair
   snap an eager composite: no single PyTorch call computes them) with
   CUDA events; the three small kernels (fused_reuse, adaLN, the pair
   snap) by device time instead, the sum of their own durations in
   torch.profiler over 20 calls with the L2 cache flushed before each,
   beside the host time of a wrapper call (the host clock over 20 calls
   without a synchronise) and the back-to-back wrapper time;
7. serves 3 requests of vdit-paper at full width through the port's
   DiffusionEngine three times - the ripple policy (40 layers),
   ``--policy svg`` and ripple with ``svg_mask`` (the first SVG_LAYERS,
   10, of the same model's layers: a cut that pays for slice 20's
   phases) - each with the launch counters set to 0 just before and read
   just after, profiles one forward of the ripple and the SVG paths (the
   ripple wrapper's collapse-flag pass, the policy's snap step and the
   SVG mask building as families of their own), then serves the ripple
   path under the decision cache (``reuse_every`` 4, 24 steps, the first
   CACHE_LAYERS, 10, layers: fused_reuse with its source map on the 7
   refresh steps only, the plain snap never on the card, the hit steps
   replaying snaps) and profiles one refresh and one hit forward, serves ``svg``
   under the cache at 2 layers (mask building on refresh steps only),
   then holds the sparse
   kernel against its plain semantics on one served SVG call at its
   full batch (operands and map kept on the host during the run, the
   bias rebuilt from q and k afterwards) and times it;
8. serves 4 requests of dit-xl2 at full width and depth (28 layers,
   gen_1024: 4096 tokens of head dim 72, 50 DDIM steps) in one batch,
   with the counters set to 0 just before and read just after: the
   adaLN, fused_reuse and ripple kernels must launch, the ripple kernel
   on tensor cores; then profiles one DiT forward at step 10;
8a. serves 4 requests of unet-sd15 at full width and depth (ch 320,
   ch_mult 1-2-4-4, 8 heads, gen_1024: latents 128 x 128 x 4, 50 DDIM
   steps) in one batch, with the counters set to 0 just before and read
   just after: every one of the 16 self-attention calls a forward goes
   through fused_reuse (twice) and the ripple kernel, on the tensor cores
   at each level's head dim (40, 80, 160); then profiles one forward at
   step 10 (convolutions and GroupNorm as families of their own);
8a''. holds fused_reuse bit for bit and the ripple kernel (tensor cores)
   at flux-dev's served joint-attention call, (4, 24, 4608, 128) bf16
   with 512 text tokens before a (1, 64, 64) grid, axes x/y, on a
   contiguous operand and on the transposed (B, N, H, d) storage the
   model hands over (``reuse[flux]``, with the kernels' times there);
   serves 4 requests of flux-dev at full width and depth (19 double
   and 38 single blocks, d_model 3072, 24 heads of 128, gen_1024: 4096
   image + 512 text tokens, Euler rectified flow cut to 12 steps) with
   the sentinels and the ladder on (``serve[flux-dev]``: exactly 1368
   fused_reuse and 684 ripple launches, no sparse or adaLN launch), the
   same batch with ripple off, one profiled forward at step 10, and the
   launcher's ``main`` on it at 2 + 4 blocks (``serve[flux-launcher]``);
8b. runs the port's kernel micro-bench (``repro_torch.launch.kernel_bench``)
   at the reference's defaults and its sparse sweep at the vDiT's serving
   width (the flash, sparse and fused_reuse kernels must launch), then
   holds the flash and sparse calls of both sweeps on their own f32
   operands against an f64 oracle, times the sparse kernel's f32 path on
   the wide svg-map call (against its bound at the f32 peak and SDPA in
   f32 with the same mask) and f32 flash on the wide operands;
   and runs the public ``reuse_snap`` wrapper at that width; each with
   the counters set to 0 just before and read just after;
8c. (inside 7, before the vDiT model is freed) runs the port's
   ``pattern_search`` at the served grid (24 heads, 1 layer, 2 steps),
   writing its artifact under ``build/patterns/``; serves the vDiT under
   ``--policy static`` with no artifact (480 sparse launches, nothing
   else; the default template's 72.0% SKIP / 28.0% FULL map; no bias;
   one plan build) and under ``--policy rainfusion`` with the searched
   artifact (fused_reuse and the sparse kernel); and (after 8a) serves 2
   requests of unet-sd15 at full width and depth under ``--policy svg``
   (20 of 50 steps: 320 sparse launches, each on the tensor cores at d 40,
   80 or 160);
8d. (inside 7, after 8c) serves four requests alternating ripple and
   static through one engine built by the launcher's
   ``make_sampler_factory`` on the loaded model (``serve[policies]``:
   two buckets, fused_reuse + ripple in one, the sparse kernel alone in
   the other, latents within 1e-3 of ``serve[ripple]`` /
   ``serve[static]``), installs the searched artifact between two steps
   of the static batch (the batch keeps its template; the next static
   request gets a bucket keyed by the new version); then, with the
   40-layer model freed, runs ``repro_torch.launch.serve.main`` itself
   (``serve[launcher]``: 8 layers, 6 requests over 3 mixed buckets,
   streamed every 4 steps, each request's latency and TTFF, its
   summary file, each result bit-equal to its batch run again in one
   piece, no degradation, retry, quarantine or watchdog trip), and
   ``serve[mesh]``: the same with a seventh request and ``--mesh 2x2``
   on 4 shards of the one card (results bit-equal, plans at batch 2 and
   1, 4x the launches); then ``dist[serve]`` (slice 20): the same argv
   under ``--distributed`` at one rank (``--coordinator`` a free local
   port): an NCCL group, an all-reduce on the card, every request
   bit-equal to ``serve[launcher]``'s with the same launches; then
   ``dist[serve mesh]``: ``serve[mesh]``'s argv under
   ``--distributed`` in two processes on the one card, each joined to a
   gloo group of 2 ranks before it calls the launcher
   (``chip_smoke.py --serve-mesh-worker``) with 2 shards a rank, so the
   ``--mesh 2x2`` spans the ranks: each rank's 7 completions bit-equal
   to ``serve[mesh]``'s, the ranks' fused_reuse and ripple launches
   summing to its, each request's latency beside its and each rank's
   peak memory (NCCL between ranks needs a card a rank: not run);
8e. (after 8d, on the launcher's 8-layer vDiT) the serving control
   plane: ``serve[slo]`` (one warm batch gives the service-time
   estimator its lower bound L; a fresh engine sharing it sheds exactly
   the requests that ``admission_decision`` proves from L and the queue
   depth; ``edf`` serves the earlier feasible deadline first and
   ``hottest`` the deepest bucket); ``serve[failover]`` (the launcher
   with ``--replicas 2``: fault-free, then ``kill_replica:after=1``,
   then ``hang:count=1`` under an 8 s ``--batch-timeout``: every request
   completes, each result equal to the fault-free run's bit for bit
   where its batch has the same members, else within relative L2
   1e-3); ``serve[guardrail]`` (``attn_nan:step=1``: a ripple batch
   launches fused_reuse and ripple, trips and is served again under
   dense with neither, bit-equal to ``--policy dense``; a static batch
   runs the sparse kernel, then fused_reuse and ripple, then neither;
   then the first on-card ``sentinel_drift`` reading with
   ``--reuse-every 4 ripple.sentinel_probe_every=4``);
8f. (after 8e) crash safety: ``serve[crash]`` (``serve[launcher]``'s argv
   with ``--journal``: the journal's and the checkpoints' costs beside
   its latencies; then the launcher in a subprocess with
   ``crash:after=1``, which must die by SIGKILL mid-generation, and a
   ``--resume`` restart in process that completes every recovered
   request, bit-equal to ``serve[launcher]`` where the batch matches,
   launching only the steps left after each resume step) and
   ``serve[resume]`` (a resume at a decision-cache hit step, bit-equal
   with equal cache counters; a checkpointed router failover, bit-equal
   to the fault-free run);
8g. (after 8a'', with ``reuse[vit]`` in the kernel section: fused_reuse
   bit for bit at vit-l16's call (128, 16, 197, 64), the cls token before
   a (1, 14, 14) grid, bf16 and f32, and its device time there) the
   vision family at full width and depth: ``classify[vit-l16]`` at
   serve_b1 and serve_b128 (224², bf16) through the classify workload
   (ripple off: no kernel of the port), ``classify[vit-l16 ripple]``
   (``vit_apply`` at a fixed θ 0.2 from step 0: 48 fused_reuse launches
   a forward and no ripple launch, as 197 tokens are odd; the snap
   fraction of Q and K and the logits' relative L2 against ripple off)
   and ``classify[efficientnet-b7]``, each with its time a batch,
   images/s and peak memory, and profiles of one serve_b128 forward;
8h. (after 8g) the LM family, with every launch counter set to 0 just
   before each run and still 0 just after (no kernel of the port lies on
   its path): ``lm[gemma3-4b prefill_32k]`` (full width and depth, 34
   layers, 2 prompts of 32768 tokens through the prefill workload, then
   a profile of one prompt's prefill by kernel family),
   ``lm[gemma3-4b decode_32k]`` (``LMEngine.generate`` greedy, 8 prompts
   of 1024 tokens, a 32768-position cache, 32 new tokens; the first two
   decoded positions' logits against ``lm_apply`` over prompt + token
   within the CPU tests' bf16 bar), ``lm[qwen2-moe-a2.7b]`` (full width
   and depth through the dense MoE path, 2 x 4096 prompt tokens, 16 new,
   the router's aux) and ``lm[qwen3-32b 16 layers]`` /
   ``lm[phi3.5-moe-42b-a6.6b 8 layers]`` (full width, cut depth, 1 x 1024,
   8 new), each with its time, tokens/s, ms a token step and peak memory;
   and on the qwen2-moe-a2.7b model already built ``lm[qwen2-moe-a2.7b ep]``
   (slice 20): ``lm_serve_steps(mesh=1x4)``, expert parallelism over 4
   model shards of the one card, 2 x 1024 prompt tokens and 3 decoded
   positions: with the capacity raised to 64 nothing drops; the bf16
   logits' distance from the dense path's is printed (the reference's
   own EP drifts from its dense path in bf16 as much,
   ``tests/test_torch_moe_ep.py``), and in float32, on one prompt, EP is
   held within 1e-4 of the dense path; at the config's 1.25 the dropped
   slots are printed; the first 2 layers in f32 on the card and on 4 CPU
   shards keep bit-equal slots;
8i. (after 8h; ``adaln[grad]`` sits with the adaLN timings in 6: the
   kernel's autograd Function against autograd of its plain version at
   the DiT's (4, 256, 1152) and (4, 4096, 1152), f32 and bf16) training
   through ``repro_torch.launch.train``: ``train[dit-xl2 grads]`` (one
   f32 step's gradients of a 2-layer dit-xl2 at d 144, every leaf random,
   through the kernel against the CPU, every leaf non-zero),
   ``train[dit-xl2]`` (``main`` at full width and depth, train_256, batch
   256 in 8 micro-batches, bf16 compute, 3 steps: per step the loss,
   grad_norm, lr, ms by CUDA events and exactly 456 adaLN launches and no
   other kernel's; samples/s and peak memory; then ``dist[train
   dit-xl2]`` (slice 20: ``python -m torch.distributed.run --standalone
   --nproc_per_node 1 chip_smoke.py --train-worker`` running the
   launcher's ``main`` with the same argv, NCCL at one rank, the state
   under ``distributed.fsdp`` (at one rank its pieces are the
   parameters): per-step losses and the checkpoint's params within 1e-6
   of the in-process run, the same adaLN launches, its ms a step by
   CUDA events beside that run's; again with ``train.grad_compression=true``, and one
   micro-batch's gradients compressed on the card bit-equal to the CPU);
   then ``profile[train dit-xl2]``,
   one step on one micro-batch of 32 by kernel family),
   ``train[vdit-paper 2 layers]``
   (full width, 8192 + 256 tokens, batch 64 cut to 1, depth 40 cut to 3),
   ``train[vit-l16]`` and ``train[efficientnet-b7]`` (cls_224, batch
   256, remat) and ``train[vdit-example]`` (the JAX package's
   examples/train_vdit.py configuration, 100 steps from 8 seeds against
   the JAX example's losses on the CPU, then a run killed after step 60
   and resumed from its step-50 checkpoint against the uninterrupted
   one);
8j. (after 8i) the LM family's training, with every launch counter set
   to 0 just before each run and still 0 just after (no kernel of the
   port lies on its path): ``train[gemma3-4b grads]`` (the loss and
   gradients of a 2-layer gemma3-4b at full width, f32, 1 x 1024 tokens
   through the chunked cross entropy, on the card against the CPU),
   ``train[gemma3-4b 28 layers]`` (``main`` at train_4k, full width and
   28 of 34 layers, or the deepest of LM_TRAIN_DEPTHS that fits; the global batch
   256 cut to 8, micro-batch 1; per step the loss, nll, grad_norm, lr
   and ms, tokens/s, the peak, the first nll against ln V; then
   ``profile[train gemma3-4b]`` on one micro-batch), ``train[qwen2-moe-
   a2.7b 4 layers]`` (full width, 4 of 24 layers, the router's aux) and
   ``train[lm-smoke learn]`` (the smoke gemma3-4b at 8 x 256 tokens, 100
   steps from 8 seeds against the JAX launcher's nll on the CPU, then a
   run killed after step 60 and resumed from step 50, bit-equal to the
   uninterrupted one);
8m. (on a thread of its own beside 9) the model axis in training:
   ``dist[train gemma3-4b tp]``, ``[qwen2-moe-a2.7b ep]`` (slice 23),
   ``[dit-xl2 tp]`` and ``[vdit-paper tp]`` (slice 24), each 2 gloo
   ranks at (data 1, model 2) on the card against one process
   (``--tp-worker``), 3 AdamW steps in f32: losses and final pieces
   within 1e-5 of the one process, the launches (adaLN's on the DiT
   equal to the one process's on each rank, the plain adaLN never on
   the card), and per rank ms a step, peak, params held and the model
   axis's bytes;
9. checks a small trajectory of each of the four paths, of the ripple
   path under the decision cache with its drift guard, of the smoke
   DiT, UNet (also under svg) and MMDiT (12 Euler steps), and of static
   and rainfusion, on the card against the same trajectory on the CPU,
   and the smoke ViT's (ripple off and at the fixed θ) and
   EfficientNet's forwards in f32 the same way, and the four smoke LMs'
   greedy ``LMEngine.generate`` in f32 (token ids equal, logits within
   the CPU tests' f32 bar), and two of the training launcher's AdamW
   steps on the smoke dit-b2 in f32 (params within 1e-5).

It prints the card's name and power limit, one JSON line describing the
kernels, and as its last line ``{"ok": true, "device": {...}}``.  Any
mismatch or error exits non-zero.  It needs one card and no network.
``--layers N`` cuts the vDiT's served depth (default: all 40 layers);
the DiT, the UNet, flux-dev, the vision models, gemma3-4b and
qwen2-moe-a2.7b always run at full depth (qwen3-32b and phi3.5-moe at
16 and 8 layers: their full-depth bf16 weights, 65.5 and 84 GB, leave no
room for a cache on one 80 GB card); in training, qwen2-moe-a2.7b runs 4
of its 24 layers and the LM cells 8 of train_4k's 256 sequences a step.  ``--baseline DIR`` runs none of the above:
it times the snap step of the checkout at DIR (for example an earlier
commit unpacked by ``git archive``) against this checkout's, in turns,
each in a process of its own (:func:`snap_ab`).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SERVE_OVERRIDES = ("model.frames=32",)  # 128 frames cut to 32: grid (8, 32, 32)
SERVE_STEPS = 12                        # step 10 snaps at θ=0.2, step 11 dense
SERVE_REQUESTS = 3
# Depth cuts that pay for the multi-process phases (slice 20): serve[svg]
# and serve[ripple+svg] (with profile[svg]) run the first 10 of the
# served model's 40 layers, serve[ripple-cache] (with its profiles) the
# first 10; the other vDiT phases keep all 40.  Beside them:
# serve[unet-svg] 50 -> UNET_SVG_STEPS DDIM steps, serve[flux-dev ripple
# off] 12 -> FLUX_OFF_STEPS Euler steps, the vision training cells 3 -> 2
# steps.
SVG_LAYERS = 10
CACHE_LAYERS = 10
DIT_SHAPE = "gen_1024"  # (128, 128, 4) latents: a (1, 64, 64) grid, 50 steps
DIT_REQUESTS = 4         # the shape's batch
UNET_SHAPE = "gen_1024"  # (128, 128, 4) latents, 50 DDIM steps
UNET_REQUESTS = 4        # the shape's batch
# unet-sd15's self-attention calls at gen_1024, batch 4, 8 heads: (B, H,
# N, d) and the (1, h, w) grid of each attention level, the mid block's
# last.
UNET_QK = (((4, 8, 16384, 40), (1, 128, 128)), ((4, 8, 4096, 80), (1, 64, 64)),
           ((4, 8, 1024, 160), (1, 32, 32)), ((4, 8, 256, 160), (1, 16, 16)))
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


def reuse_operand(shape, dtype, seed, noise, view="contiguous", text=(0, 0)):
    """A correlated (B, H, text[0] + N + text[1], d) operand (``shape`` =
    (B, H, N, d) counts grid tokens only) behind ``view``: "contiguous";
    "transposed" (stored (B, N', H, d), as q is before its copy);
    "narrowed" (a channel window of a wider row, 16-byte aligned);
    "unaligned" (the same, shifted by 2 channels off 16 bytes)."""
    import torch

    B, H, N, d = shape
    full = (B, H, text[0] + N + text[1], d)
    x = correlated(full, dtype, seed, noise)
    if view == "transposed":
        return x.transpose(1, 2).contiguous().transpose(1, 2)
    if view in ("narrowed", "unaligned"):
        off = 8 if view == "narrowed" else 2
        big = torch.zeros((*full[:3], d + 16), dtype=dtype, device="cuda")
        big[..., off:off + d] = x
        return big[..., off:off + d]
    return x


def check_reuse(results, shape, grid, dtype, gran, thetas, axes=("t", "x", "y"),
                view="contiguous", text=(0, 0)):
    """The kernel bit for bit against its plain version (the host pipeline
    on the grid tokens, text tokens passed through) on the same card
    tensors; logs whether the 16-byte or the scalar instance ran."""
    import torch
    from repro_torch.core.reuse import snap_grid_tokens
    from repro_torch.kernels import _build
    from repro_torch.kernels.reuse_mask import ops as reuse_ops

    # The token gate averages Δ over channels: less noise, so it fires.
    x = reuse_operand(shape, dtype, len(results), 0.6 if gran == "channel" else 0.3,
                      view, text)
    gs = (text[0], shape[2]) if text != (0, 0) else None
    th = dict(zip("txy", thetas))
    s_k, m_k = reuse_ops.fused_compute_reuse(x, grid, th, axes=axes, granularity=gran,
                                             grid_slice=gs)
    ref_s, ref_m = snap_grid_tokens(x, grid, th, gs, axes=axes, granularity=gran)
    torch.cuda.synchronize()
    ok = bits_equal(s_k, ref_s) and bits_equal(m_k, ref_m)
    if text != (0, 0):  # the text rows come back untouched, unmasked
        for at, n in ((0, text[0]), (text[0] + shape[2], text[1])):
            ok &= bits_equal(s_k.narrow(-2, at, n), x.narrow(-2, at, n)) \
                and not m_k.narrow(-2, at, n).any().item()
    err = (s_k.float() - ref_s.float()).abs().max().item()
    n0, n1, s0, s1 = reuse_ops._lead_dims(x)
    vec = _build.function("fused_reuse", "fused_reuse_vector_path",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                          + [ctypes.c_longlong] * 5)(
        int(dtype == torch.bfloat16), shape[3], x.data_ptr(), n0, s0, n1, s1,
        x.stride(-2))
    name = str(dtype).replace("torch.", "")
    log(f"kernel fused_reuse {name:8s} {gran:7s} x{tuple(x.shape)} grid{grid} "
        f"axes={''.join(axes)} {view} text {text} ({'16-byte' if vec else 'scalar'} "
        f"instance): bit-equal={ok} snapped={m_k.float().mean().item():.4f}")
    results.append(ok)
    if not ok:
        raise SystemExit("fused_reuse kernel disagrees with its plain version")
    return err


SERVE_SNAP = (3, 24, 8192, 128)  # the vDiT's served Q/K grid tokens at batch 3
SERVE_TEXT = (256, 0)            # 256 text tokens before them
# serve[launcher]'s half-resolution bucket: Q/K grid tokens at batch 2 on
# grid (8, 16, 16), the same 256 text tokens before them.
HALF_GRID = (8, 16, 16)
HALF_SNAP = (2, 24, 8 * 16 * 16, 128)


def reuse_checks(serve_grid, dit_qk, dit_grid):
    """Every fused_reuse case, then the served-shape ``snap_operand`` check;
    returns the main-path case's max abs error."""
    import torch
    from repro_torch.config.base import RippleConfig
    from repro_torch.core.policy import snap_operand

    bf16, f32 = torch.bfloat16, torch.float32
    res = []
    th = (0.2, 0.25, 0.3)
    serve_qk = (1, 24, serve_grid[0] * serve_grid[1] * serve_grid[2], 128)
    for dt in (bf16, f32):
        for gran in ("channel", "token"):
            check_reuse(res, serve_qk, serve_grid, dt, gran, th)
            check_reuse(res, (2, 3, 4 * 6 * 8, 64), (4, 6, 8), dt, gran, th)
            check_reuse(res, (1, 2, 8 * 8, 32), (1, 8, 8), dt, gran, th)
    check_reuse(res, (1, 2, 4 * 6 * 8, 64), (4, 6, 8), bf16, "channel", th,
                axes=("y", "t", "x"))
    # The DiT's case: T = 1 (the one-frame instance), x/y axes, head dim 72
    # at dit-xl2's gen_1024 shape.
    for dt in (bf16, f32):
        for gran in ("channel", "token"):
            check_reuse(res, dit_qk, dit_grid, dt, gran, th, axes=("x", "y"))
    # unet-sd15's four self-attention calls at gen_1024 (T = 1, x/y, head
    # dims 40, 80, 160; d 40 is 5 sixteen-byte chunks a bf16 row).
    for qk, grid in UNET_QK:
        check_reuse(res, qk, grid, bf16, "channel", th, axes=("x", "y"))
    # Views read in place, text tokens copied through, TT 1 and 2, d 72 and
    # 128, both gates and dtypes, and the scalar instance (bf16 d 36, f32 d
    # 6, and an unaligned view).
    small = {128: (2, 3, 4 * 8 * 8, 128), 72: (2, 3, 4 * 8 * 8, 72)}
    for dt in (bf16, f32):
        for d, shp in small.items():
            for gran in ("channel", "token"):
                for view, text, axes in (("transposed", (0, 0), ("t", "x", "y")),
                                         ("narrowed", (5, 3), ("x", "t", "y")),
                                         ("transposed", (16, 0), ("x", "y")),
                                         ("unaligned", (3, 0), ("t", "x", "y"))):
                    check_reuse(res, shp, (4, 8, 8), dt, gran, th, axes=axes,
                                view=view, text=text)
        for d in ((36,) if dt == bf16 else (6, 36)):
            for gran in ("channel", "token"):
                check_reuse(res, (2, 2, 2 * 4 * 6, d), (2, 4, 6), dt, gran, th,
                            view="transposed", text=(7, 2))
    check_reuse(res, (1, 24, 8192, 128), serve_grid, bf16, "channel", th,
                view="transposed", text=SERVE_TEXT)
    # serve[launcher]'s half-resolution bucket, as q and k reach the kernel.
    for view in ("contiguous", "transposed"):
        check_reuse(res, HALF_SNAP, HALF_GRID, bf16, "channel", th, view=view,
                    text=SERVE_TEXT)
    # The served call: snap_operand at batch 3 through the kernel (one
    # launch on the whole operand) and through the host pipeline.
    x = reuse_operand(SERVE_SNAP, bf16, 30, 0.6, text=SERVE_TEXT)
    cfg = RippleConfig(enabled=True)
    args = (x, True, serve_grid, dict(zip("txy", (0.2,) * 3)), cfg, ("t", "x", "y"),
            (SERVE_TEXT[0], SERVE_SNAP[2]))
    s_k, m_k = snap_operand(*args, use_fused=True)
    s_h, m_h = snap_operand(*args, use_fused=False)
    torch.cuda.synchronize()
    ok = bits_equal(s_k, s_h) and bits_equal(m_k, m_h)
    err = (s_k.float() - s_h.float()).abs().max().item()
    log(f"kernel fused_reuse: snap_operand at the served shape {tuple(x.shape)} grid "
        f"slice {args[-1]}, kernel vs host pipeline: bit-equal={ok} snapped="
        f"{m_k.float().mean().item():.4f}")
    res.append(ok)
    if not ok:
        raise SystemExit("snap_operand through the kernel differs from the host pipeline")
    theta_sweep_checks(res)
    log(f"kernel fused_reuse: {sum(res)}/{len(res)} cases bit-equal")
    return err


def check_source_map(results, shape, grid, dtype, gran, thetas, axes=("t", "x", "y"),
                     view="contiguous", text=(0, 0)):
    """The kernel's snap-source map (``want_src``) on the card: bit-equal
    to the plain ``compute_reuse(want_src=True).src_idx`` on the grid
    tokens, the snapped values and mask bit-equal to the call without the
    map, and gathering the grid tokens by the map bit-equal to their
    snapped values.  Returns the largest |snapped - x| of the call."""
    import torch
    from repro_torch.core.reuse import compute_reuse
    from repro_torch.kernels.reuse_mask import ops as reuse_ops

    x = reuse_operand(shape, dtype, 100 + len(results),
                      0.6 if gran == "channel" else 0.3, view, text)
    gs = (text[0], shape[2])
    th = dict(zip("txy", thetas))
    kw = dict(axes=axes, granularity=gran, grid_slice=gs)
    s_k, m_k, src = reuse_ops.fused_compute_reuse(x, grid, th, want_src=True, **kw)
    s_0, m_0 = reuse_ops.fused_compute_reuse(x, grid, th, **kw)
    seg = x.narrow(-2, *gs)
    ref = compute_reuse(seg, grid, th, axes=axes, granularity=gran, want_src=True)
    gathered = torch.gather(seg, -2, src)
    torch.cuda.synchronize()
    ok = (src.dtype == torch.int32 and torch.equal(src, ref.src_idx)
          and bits_equal(s_k, s_0) and bits_equal(m_k, m_0)
          and bits_equal(gathered, s_k.narrow(-2, *gs)))
    frac = m_k.narrow(-2, *gs).float().mean().item()
    name = str(dtype).replace("torch.", "")
    log(f"kernel fused_reuse source map {name:8s} {gran:7s} x{tuple(x.shape)} grid{grid} "
        f"axes={''.join(axes)} {view} text {text}: map bit-equal to compute_reuse("
        f"want_src=True), outputs equal to the call without it, gather by it equals "
        f"snapped: {ok}; snapped {frac:.4f}")
    results.append(ok and frac > 0)
    if not results[-1]:
        raise SystemExit("fused_reuse kernel's source map disagrees with its plain version")
    del ref, gathered, src
    return (s_k.float() - x.float()).abs().max().item()


def source_map_checks(serve_grid, dit_qk, dit_grid):
    """The source map at the served vDiT call (batch 3, 256 text
    tokens), the DiT's call (T = 1, axes xy, d 72), the scalar instance
    (bf16 d 36 and f32 d 6, unaligned and transposed views), the token
    gate, and f32 and bf16."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    res = []
    th = (0.2, 0.25, 0.3)
    check_source_map(res, SERVE_SNAP, serve_grid, bf16, "channel", (0.2,) * 3,
                     text=SERVE_TEXT)
    check_source_map(res, dit_qk, dit_grid, bf16, "channel", (0.2,) * 3, axes=("x", "y"))
    for dt in (bf16, f32):
        for gran in ("channel", "token"):
            check_source_map(res, (2, 3, 4 * 8 * 8, 128), (4, 8, 8), dt, gran, th,
                             axes=("x", "t", "y"), view="narrowed", text=(5, 3))
            check_source_map(res, dit_qk, dit_grid, dt, gran, th, axes=("x", "y"),
                             view="transposed")
        for d, view in ((36 if dt == bf16 else 6, "transposed"), (36, "unaligned")):
            check_source_map(res, (2, 2, 2 * 4 * 6, d), (2, 4, 6), dt, "channel", th,
                             view=view, text=(7, 2))
    check_source_map(res, SERVE_SNAP, serve_grid, f32, "channel", (0.2,) * 3,
                     text=SERVE_TEXT)
    log(f"kernel fused_reuse source map: {sum(res)}/{len(res)} cases bit-equal")
    torch.cuda.empty_cache()


def theta_sweep_checks(res):
    """The kernel's square-root-free channel gate at every θ a served
    schedule gives: each bf16 value from 0.2 to 0.5, the schedules' own
    float32 values (vdit-paper over its served steps, dit-xl2 over 50),
    and 0, denormals, 1.0 and inf; bf16 and f32, the 16-byte and the
    scalar instance, each held bit for bit against the plain version.
    The token gate (no s*) at the edge values."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.reuse import snap_grid_tokens
    from repro_torch.core.schedule import threshold_schedule
    from repro_torch.kernels import _build
    from repro_torch.kernels.reuse_mask import ops as reuse_ops

    bf16_vals = torch.arange(0x3E40, 0x3F01, dtype=torch.int16).view(torch.bfloat16)
    sweep = [v for v in bf16_vals.float().tolist() if 0.2 <= v <= 0.5]
    for name, steps in (("vdit-paper", SERVE_STEPS), ("dit-xl2", 50)):
        sweep += threshold_schedule(get_config(name).ripple, steps)
    edges = [0.0, 2.0 ** -149, 2.0 ** -133, 2.0 ** -130, 1.0, float("inf")]
    grid = (4, 8, 8)
    for dt in (torch.bfloat16, torch.float32):
        for d, view in ((64, "contiguous"), (36 if dt == torch.bfloat16 else 6, "transposed")):
            x = reuse_operand((1, 2, 256, d), dt, 40 + d, 0.6, view)
            n0, n1, s0, s1 = reuse_ops._lead_dims(x)
            vec = _build.function("fused_reuse", "fused_reuse_vector_path",
                                  [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                                  + [ctypes.c_longlong] * 5)(
                int(dt == torch.bfloat16), d, x.data_ptr(), n0, s0, n1, s1, x.stride(-2))
            cases = [(th, "channel") for th in sorted(set(sweep + edges))]
            cases += [(th, "token") for th in edges]
            fracs, ok = [], True
            for th, gran in cases:
                th3 = dict(zip("txy", (th,) * 3))
                s_k, m_k = reuse_ops.fused_compute_reuse(x, grid, th3, granularity=gran)
                s_h, m_h = snap_grid_tokens(x, grid, th3, None, granularity=gran)
                same = bits_equal(s_k, s_h) and bits_equal(m_k, m_h)
                if not same:
                    log(f"kernel fused_reuse: θ {th!r} ({gran}) differs")
                ok &= same
                fracs.append(m_k.float().mean().item())
            log(f"kernel fused_reuse {str(dt)[6:]:8s} θ sweep x{tuple(x.shape)} {view} "
                f"({'16-byte' if vec else 'scalar'} instance): {len(cases)} θ from "
                f"{min(sweep):.6g} to {max(sweep):.6g} plus {edges}; bit-equal={ok}; "
                f"snapped fraction {min(fracs):.4f} to {max(fracs):.4f}")
            res.append(ok)
            if not ok:
                raise SystemExit("fused_reuse kernel disagrees with its plain version "
                                 "in the θ sweep")


def host_ab_ms(fns, rounds=5, iters=200):
    """Host time a call of each of ``fns``: the median over ``rounds``
    alternating rounds of ``iters`` calls each, synchronised between
    rounds only, so that the shared host's drift falls on all alike."""
    import torch

    times = [[] for _ in fns]
    for fn in fns:
        fn()
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            t.append((time.perf_counter() - t0) * 1e3 / iters)
    torch.cuda.synchronize()
    return [sorted(t)[len(t) // 2] for t in times]


def device_time_ms(fn, kernel=None, iters=20, flush=None, per_call=1):
    """Device time a call of ``fn`` and host time a call.  Device: the
    durations of the kernels whose name holds ``kernel`` (each call must
    launch exactly ``per_call``; None: every kernel of the call, each name
    a whole number of times a call) over ``iters`` calls recorded by
    torch.profiler after a warm-up round outside it, with the L2 cache
    evicted before each call when ``flush`` (from :func:`l2_flush`) is
    given.  Host: the host clock over ``iters`` calls with no synchronise
    between them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()

    def record(body):
        body()  # warm-up, not recorded
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        return [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]

    skip = set()
    for _ in range(3 if flush is not None else 0):
        skip = {ev.name for ev in record(lambda: flush.max())}
        if skip:
            break
    if flush is not None and not skip:
        raise SystemExit("profiler saw no kernel of the L2 flush")

    def calls():
        for _ in range(iters):
            if flush is not None:
                flush.max()
            fn()

    # The profiler has dropped kernel records now and then (19 of 20; once
    # 17, 0, 12 and 12 of 20 in a row): a reading with another count is
    # taken again, at most five times, and then the same calls are timed
    # by CUDA events instead.
    for _ in range(5):
        durs = {}
        for ev in record(calls):
            if ev.name not in skip and (kernel is None or kernel in ev.name):
                durs.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
        counts = {name: len(v) for name, v in durs.items()}
        if (durs and (kernel is None or sum(counts.values()) == iters * per_call)
                and not any(n % iters for n in counts.values())):
            return sum(sum(v) for v in durs.values()) / iters / 1e3, host_ms
        log(f"profiler saw {counts} launches of {kernel or 'the call'}, not {iters} "
            f"calls' worth; reading again")
    ms = event_time_ms(fn, iters, flush)
    log(f"profiler dropped records five times: {kernel or 'the call'} timed by CUDA "
        f"events around each call instead: {ms:.4f} ms a call")
    return ms, host_ms


def event_time_ms(fn, iters=20, flush=None):
    """Device time of a call of ``fn``: a pair of CUDA events around each
    of ``iters`` calls, the L2 evicted before each (outside the pair)
    when ``flush`` is given.  The fallback of :func:`device_time_ms`: it
    also counts the gaps between the call's kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        if flush is not None:
            flush.max()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def reuse_bound(x, grid, want_src=False):
    """(bound ms, bound by, bytes) of one fused_reuse call on x
    (``launch.roofline.reuse_work``)."""
    from repro_torch.launch import roofline

    w = roofline.reuse_work(x.shape, x.element_size(), grid, want_src)
    return (*w.bound(), w.nbytes)


def time_fused_reuse(x, grid, axes, grid_slice, label, flush, want_src=False):
    """fused_reuse on x as its path calls it (channel gate, θ 0.2; with
    ``want_src`` as a refresh step of the decision cache calls it, the
    source map written too): device time with the L2 flushed and back to
    back, host time a wrapper call, the old back-to-back wrapper time,
    the plain version's time, and the bound.  Returns them as a dict."""
    from repro_torch.core.reuse import snap_grid_tokens
    from repro_torch.kernels.reuse_mask import ops as reuse_ops

    th = dict(zip("txy", (0.2,) * 3))

    def call():
        return reuse_ops.fused_compute_reuse(x, grid, th, axes=axes, grid_slice=grid_slice,
                                             want_src=want_src)

    ms, host = device_time_ms(call, "fused_reuse_kernel", flush=flush)
    warm, _ = device_time_ms(call, "fused_reuse_kernel")
    wrap = cuda_time_ms(call, iters=20)
    plain = cuda_time_ms(lambda: snap_grid_tokens(x, grid, th, grid_slice, axes=axes,
                                                  want_src=want_src),
                         iters=3, warmup=1)
    bound, by, nbytes = reuse_bound(x, grid, want_src)
    log(f"time fused_reuse {str(x.dtype)[6:]} {tuple(x.shape)} grid {grid} slice {grid_slice} axes "
        f"{''.join(axes)} ({label}{', with the source map' if want_src else ''}): device {ms:.4f} ms a call (L2 flushed; {bound / ms:.3f} "
        f"of the bound), {warm:.4f} ms back to back; host {host:.4f} ms a wrapper call, "
        f"wrapper time back to back {wrap:.4f} ms; plain {plain:.4f} ms; bound "
        f"{bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB); {CARD}")
    return {"ms": ms, "host_ms": host, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by}


def l2_flush():
    """A 256 MB buffer: reading it (``max``, whose kernels are left out of
    the measured time) evicts the card's 50 MB L2 and leaves it clean, so
    no write-back of the flush lands in a measured call."""
    import torch

    return torch.zeros(64 << 20, dtype=torch.int32, device="cuda")


# ---------------------------------------------------------------------------
# Kernel 2: pair-collapse attention
# ---------------------------------------------------------------------------


# Head dims of the ripple kernel's tensor-core path (bf16, d == dv).
TC_DIMS = (32, 40, 64, 72, 80, 128, 160)


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
    probabilities to bf16 before the PV product (the row sum stays f32).
    A collapsed key tile rounds nothing more there: the kernel multiplies
    both halves of V by the same rounded probability, as dense attention
    on the snapped keys does.  The CUDA-core path rounds neither (it sums
    v_even + v_odd of a collapsed tile in f32)."""
    import torch

    B, H, N, _ = q.shape
    out = torch.empty((B, H, N, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for h in range(H):
        qh, kh, vh = q[:, h].float(), k[:, h].float(), v[:, h].float()
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


def f32_logit_slack(q, k, v) -> float:
    """What f32 logits far from O(1) add to the f32 bar, for a kernel held
    against an exact (f64) oracle.  The kernel_bench sweep's operands
    (correlated latents through 0.4-scaled random projections) reach
    |logits| ~ 130, where f32 logits are off by ~1e-4.  Each output is a
    p-weighted mean of v, so logits off by at most δ move it by at most
    2·δ·max|v|.  δ is twice E, the largest gap between the f32 and the
    f64 scaled logits of the same q, k (the kernel sums each product in
    another order), plus 2^-22 of max|logit| for the f32 roundings of the
    scale, of the scale in log2 units and of each scaled logit."""
    import torch

    B, H, _, d = q.shape
    scale = 1.0 / d ** 0.5
    gap = top = 0.0
    for b in range(B):
        for h in range(H):
            s64 = torch.matmul(q[b, h].double(), k[b, h].double().T) * scale
            s32 = torch.matmul(q[b, h].float(), k[b, h].float().T) * scale
            gap = max(gap, (s32.double() - s64).abs().max().item())
            top = max(top, s64.abs().max().item())
            del s64, s32
    return 2 * v.float().abs().max().item() * (2 * gap + 2.0 ** -22 * top)


def unet_ripple_checks(results):
    """The ripple kernel at unet-sd15's head dims: bf16 at d 40, 80 and 160
    on the tensor cores (collapse fractions 0, 0.6 and 1; B*H > 1 with a
    ragged last tile; all-collapsed keys under dense queries and the other
    way round; the four served shapes, constructed and as the path makes
    them: snapped by fused_reuse on x/y at θ 0.2), then the CUDA cores at d
    160 and 256 in f32 and d 256 in bf16.  Returns the main-path snapped
    operands of the three timed shapes."""
    import torch
    from repro_torch.kernels.reuse_mask import ops as reuse_ops
    from repro_torch.kernels.ripple import ops as ripple_ops

    bf16, f32 = torch.bfloat16, torch.float32
    tile = ripple_ops.TILE_PAIRS

    def case(shape, fq, fk, dt, label, seed):
        q = snapped_operand(shape, fq, seed, dt, tile)
        k = snapped_operand(shape, fk, seed + 1, dt, tile)
        v = snapped_operand(shape, 0.0, seed + 2, dt, tile)
        check_ripple(results, q, k, v, label)

    for d in (40, 80, 160):
        for frac in (0.0, 0.6, 1.0):
            case((1, 2, 256, d), frac, frac, bf16, f"N=256 d={d} frac={frac}", 40 + d)
        for fq, fk in ((0.6, 0.6), (1.0, 1.0), (0.0, 1.0), (1.0, 0.0)):
            case((2, 3, 418, d), fq, fk, bf16, f"(2, 3, 418, {d}) q frac={fq} "
                 f"k frac={fk} (ragged, B*H > 1)", 50 + d)
    for d, dt in ((160, f32), (256, f32), (256, bf16)):
        for frac in (0.6, 1.0):
            case((1, 2, 130, d), frac, frac, dt, f"N=130 d={d} frac={frac} "
                 f"(unaligned)", 60 + d)
    served = {}
    for i, (qk, grid) in enumerate(UNET_QK):
        case(qk, 0.6, 0.6, bf16, f"{qk} frac=0.6 (unet-sd15 serving shape)", 70 + i)
        q, k = (reuse_ops.fused_compute_reuse(
            correlated(qk, bf16, seed), grid, dict(zip("txy", (0.2,) * 3)),
            axes=("x", "y"))[0] for seed in (80 + i, 90 + i))
        v = correlated(qk, bf16, 100 + i)
        err = check_ripple(results, q, k, v, f"{qk} unet-sd15 main-path snapped operands")
        if i < 3:
            served[qk] = (q, k, v, err)
        else:
            del q, k, v
    torch.cuda.empty_cache()
    return served


def ripple_bound(q, k, dv):
    """(bound ms, bound by, flops, exponentials, bytes) of one ripple call
    on these operands (``launch.roofline.ripple_work``), with the score
    and PV products the operands need: the rows and keys a collapsed tile
    leaves (:func:`ripple_tile_stats`)."""
    from repro_torch.kernels.ripple import ops as ripple_ops
    from repro_torch.launch import roofline

    _, _, flops = ripple_ops.ripple_tile_stats(q, k, dv)
    w = roofline.ripple_work(q.shape, dv, q.element_size(), flops)
    return (*w.bound(), w.ops, w.exps, w.nbytes)


def time_unet_ripple(served):
    """The ripple kernel at unet-sd15's three head dims, on the main
    path's snapped operands (batch 4, 8 heads): the kernel's device time
    (torch.profiler, back to back: at d 160 a call is tens of µs, below
    the wrapper's host time) beside the wrapper's CUDA-event time, the
    plain version (a loop over the batch rows: the full batch's dense
    scores at 16384 tokens would take 34 GB), SDPA's device and
    CUDA-event times, and the bound.  Returns one dict an instance."""
    import torch
    from repro_torch.kernels.ripple import ops as ripple_ops
    from repro_torch.kernels.ripple.ref import ripple_attention_ref
    from repro_torch.launch import roofline

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for qk, (q, k, v, err) in served.items():
        d = qk[-1]
        scale = ripple_ops.attention_scale(d)
        ms, host = device_time_ms(lambda: ripple_ops.ripple_attention(q, k, v),
                                  "ripple_wgmma_kernel")
        wrap = cuda_time_ms(lambda: ripple_ops.ripple_attention(q, k, v), iters=10)
        plain = cuda_time_ms(lambda: [ripple_attention_ref(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], scale) for b in range(q.shape[0])],
            iters=2, warmup=1)
        lib, _ = device_time_ms(lambda: sdpa(q, k, v, scale=scale))
        lib_wrap = cuda_time_ms(lambda: sdpa(q, k, v, scale=scale), iters=10)
        bound, by, flops, exps, nbytes = ripple_bound(q, k, d)
        parts = {k_: t * 1e3 for k_, t in roofline.ripple_work(
            q.shape, d, q.element_size(), flops).terms().items()}
        qf, kf, _ = ripple_ops.ripple_tile_stats(q, k, d)
        log(f"time ripple_attention bf16 {qk} (unet-sd15, d {d}, tensor cores "
            f"{ripple_ops.uses_tensor_cores(q, v)}; tiles collapsed q {qf:.3f} k "
            f"{kf:.3f}): kernel device {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s, "
            f"{exps / ms / 1e9:.3f} T exp/s), wrapper back to back {wrap:.4f} ms, host "
            f"{host:.4f} ms a wrapper call; plain {plain:.4f} ms; sdpa device "
            f"{lib:.4f} ms, back to back {lib_wrap:.4f} ms; "
            f"bound {bound:.4f} ms ({by}: {flops / 1e12:.4f} TFLOP, {exps / 1e9:.3f} G "
            f"exponentials, {nbytes / 1e6:.1f} MB); each bound: " + ", ".join(
                f"{n} {t:.4f} ms (bound/kernel {t / ms:.3f})" for n, t in parts.items())
            + f"; kernel/sdpa {ms / lib:.3f}; {CARD}")
        out.append({"shape": list(qk), "ms": ms, "wrapper_ms": wrap, "host_ms": host,
                    "plain_ms": plain, "bound_ms": bound,
                    "bound_by": "bytes" if by == "bytes" else "operations",
                    "bound_detail": by, "bound_parts_ms": parts,
                    "library_ms": lib, "library_wrapper_ms": lib_wrap,
                    "max_abs_err": err})
    served.clear()
    torch.cuda.empty_cache()
    return out


def check_ripple(results, q, k, v, label):
    """The kernel against :func:`attention_oracle`; every bf16 case with a
    head dim in ``TC_DIMS`` must take the tensor cores, no other case."""
    import torch
    from repro_torch.kernels.ripple import ops as ripple_ops

    out = ripple_ops.ripple_attention(q, k, v)
    tc = ripple_ops.uses_tensor_cores(q, v)
    want_tc = (q.dtype == torch.bfloat16 and q.shape[-1] == v.shape[-1]
               and q.shape[-1] in TC_DIMS)
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


def sparse_oracle(q, k, v, bias, bmap, blk, round_p, exact=False):
    """f32 block-sparse softmax attention with the kernel's conventions
    (FULL tiles ignore the bias, SKIP tiles drop out, the running max is
    floored at -1e30, a row with no live key emits 0), one head at a time.
    ``round_p`` rounds the probabilities to bf16 before the PV product,
    where the bf16 kernel rounds them (the row sum stays f32); ``exact``
    computes in f64 instead of f32."""
    import torch
    from repro_torch.kernels.sparse.ref import PARTIAL, SKIP, expand_block_map

    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    scale = float(1.0 / (d ** 0.5))
    wt = torch.float64 if exact else torch.float32
    out = torch.empty((B, H, Nq, v.shape[-1]), dtype=wt, device=q.device)
    bm = bmap.expand(B, H, *bmap.shape[-2:])
    be = None if bias is None else bias.expand(B, H, Nq, Nk)
    for b in range(B):
        for h in range(H):
            s = torch.matmul(q[b, h].to(wt), k[b, h].to(wt).T) * scale
            st = expand_block_map(bm[b, h], Nq, Nk, blk, blk)
            if be is not None:
                s = torch.where(st == PARTIAL, s + be[b, h].to(wt), s)
            s = s.masked_fill(st == SKIP, float("-inf"))
            p = torch.exp(s - s.amax(-1, keepdim=True).clamp(min=-1e30))
            l = p.sum(-1, keepdim=True)
            if round_p:
                p = p.bfloat16().to(wt)
            out[b, h] = torch.matmul(p, v[b, h].to(wt)) / torch.where(
                l > 0, l, torch.ones_like(l))
            del s, st, p
    return out


# The head dims whose bf16 calls (d == dv) take the tensor cores.
SPARSE_TC_DIMS = (32, 40, 64, 80, 128, 160)


def check_sparse(results, label, q, k, v, bias, bmap, blk, sdpa=False, slack=None):
    """The kernel against :func:`sparse_oracle` at ``attn_tol`` (bf16
    rounds probabilities where the kernel does); a bf16 call at a head dim
    of ``SPARSE_TC_DIMS`` must take the tensor cores, no other call; an
    all-SKIP map must give exact zeros; ``sdpa`` also holds an all-FULL
    call against
    ``scaled_dot_product_attention``.  With ``slack`` (f32 operands whose
    logits are far from O(1), :func:`f32_logit_slack`) the oracle is
    exact and the bar is ``attn_tol`` plus the slack.  Returns the max abs
    error."""
    import torch
    from repro_torch.kernels.sparse import ops as sparse_ops
    from repro_torch.kernels.sparse.ref import SKIP

    out = sparse_ops.sparse_attention(q, k, v, bias=bias, block_map=bmap,
                                      block_q=blk, block_k=blk)
    tc = sparse_ops.uses_tensor_cores(q, v)
    want_tc = (q.dtype == torch.bfloat16 and q.shape[-1] == v.shape[-1]
               and q.shape[-1] in SPARSE_TC_DIMS)
    ref = sparse_oracle(q, k, v, bias, bmap, blk, round_p=q.dtype == torch.bfloat16,
                        exact=slack is not None)
    torch.cuda.synchronize()
    err = (out.to(ref.dtype) - ref).abs().max().item()
    name = str(q.dtype).replace("torch.", "")
    tol = attn_tol(name, ref) + (slack or 0.0)
    ok = err <= tol and bool(torch.isfinite(out).all()) and tc == want_tc
    extra = "" if slack is None else f"; vs f64, logit slack {slack:.3g}"
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
    path = "CUDA cores"
    if tc:  # with a bias, a PARTIAL tile's stage also takes a ring slot for it
        path = f"tensor cores, {'bias ring' if bias is not None else 'no-bias ring'}"
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
        # One (N, N) bias slab read through zero batch and head strides, on
        # a map that is mostly PARTIAL.
        N, blk = 512, 64
        nb = N // blk
        q, k, v = (torch.randn((2, 3, N, 128), generator=g, device="cuda").to(dt)
                   for _ in range(3))
        states = torch.randint(0, 2, (2, 3, nb, nb), generator=g, device="cuda",
                               dtype=torch.int32)
        heavy = torch.rand((2, 3, nb, nb), generator=g, device="cuda") < 0.7
        states = torch.where(heavy, torch.full_like(states, PARTIAL), states)
        bias = torch.randn((1, 1, N, N), generator=g, device="cuda")
        check_sparse(res, "PARTIAL-heavy map, bias broadcast over batch and heads",
                     q, k, v, bias, states, blk)
        # Every map row live at its two ends only: the producer skips the
        # tiles between, and the ring wraps within a row (4 slots a row
        # against 3 at d 128: two PARTIAL stages of K/V and bias, or two
        # 256-key tiles of two stages each).
        N = 2048
        q, k, v = qkv(N, 128, dt)
        bias = torch.randn((1, 2, N, N), generator=g, device="cuda")
        for blk, b, ends in ((128, bias, (PARTIAL, PARTIAL)), (256, None, (FULL, FULL))):
            nb = N // blk
            bmap = torch.full((1, 2, nb, nb), SKIP, dtype=torch.int32, device="cuda")
            bmap[..., 0], bmap[..., -1] = ends
            check_sparse(res, f"live tiles at both ends of each map row, block {blk}, "
                         f"{'bias' if b is not None else 'no bias'}", q, k, v, b, bmap, blk)
        del q, k, v, bias, bmap
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
    """(bound ms, 'bytes' or 'operations', flops, bytes) of one call
    (``launch.roofline.sparse_work``) on the tiles this map leaves
    (``sparse_areas``)."""
    from repro_torch.launch import roofline

    bshape = None if bias is None else tuple(bias.shape)
    live, partial, n_map = roofline.sparse_areas(bmap, q.shape, v.shape[2], blk,
                                                 bshape)
    w = roofline.sparse_work(q.shape, v.shape[2], v.shape[3], q.dtype, blk,
                             live=live, partial=partial, map_numel=n_map,
                             bias_shape=bshape)
    return (*w.bound(), w.ops, w.nbytes)


def spatial_local_keep(grid, radius):
    """The (N, N) keep of the ``spatial_local`` template on a T = 1 grid,
    built on the card: same-frame keys within Chebyshev distance
    ``radius``."""
    import torch

    _, h, w = grid
    idx = torch.arange(h * w, device="cuda")
    y, x = idx // w, idx % w
    return (((y[:, None] - y[None, :]).abs() <= radius)
            & ((x[:, None] - x[None, :]).abs() <= radius))


def unet_served_map(grid, blk=128):
    """A constructed map at a unet-sd15 level: the UNet's default template
    (``spatial_local``, radius a quarter of the side) with every key kept
    for the first query tile, so the map has FULL, PARTIAL and (from 1024
    tokens on) SKIP tiles; the bias is -inf off the keep and a finite
    random term on it, one (1, 1, N, N) f32 slab broadcast over batch and
    heads.  Returns (bias, map)."""
    import torch
    from repro_torch.kernels.sparse.ops import block_map_from_keep

    keep = spatial_local_keep(grid, max(1, min(grid[1:]) // 4))
    keep[:blk] = True
    g = torch.Generator(device="cuda")
    g.manual_seed(sum(grid))
    bias = torch.where(keep, 0.5 * torch.randn(keep.shape, generator=g, device="cuda"),
                       float("-inf"))
    bmap = block_map_from_keep(keep, blk, blk)
    del keep
    return bias[None, None], bmap


def unet_sparse_checks(results):
    """The sparse kernel at unet-sd15's head dims: bf16 at d 40, 80 and 160
    on the tensor cores (all-FULL against SDPA, all-SKIP, mixed maps under
    -inf and finite PARTIAL biases, B*H > 1 with a ragged N, a
    PARTIAL-heavy map under a bias broadcast over batch and heads, map rows
    live only at their two ends so the ring wraps); the CUDA cores at d 160
    and 256 in f32, d 256 in bf16 and bf16 at d 160 with dv 256; then the
    four served calls (batch 4, 8 heads) all-FULL as ``svg`` serves them
    at T = 1 and on a constructed map with SKIP, FULL and PARTIAL tiles
    and a bias (:func:`unet_served_map`).  Returns the served calls'
    operands, maps and errors for :func:`time_unet_sparse`."""
    import torch
    from repro_torch.kernels.sparse.ops import (FULL, PARTIAL, SKIP,
                                                block_map_from_keep, sparse_grid)

    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device="cuda")
    g.manual_seed(130)

    def qkv(shape, dt, dv=None):
        B, H, N, d = shape
        return tuple(torch.randn((B, H, N, n), generator=g, device="cuda").to(dt)
                     for n in (d, d, dv or d))

    def mixed_keep(shape, blk):
        B, H, N = shape[:3]
        keep = torch.rand((B, H, N, N), generator=g, device="cuda") < 0.5
        keep[..., :blk, :blk] = True             # a FULL tile
        keep[..., blk:2 * blk, :blk] = False     # a SKIP tile
        return keep

    def neg_inf(keep):
        return torch.where(keep, 0.0, float("-inf")).float()

    def states(shape, blk):
        nb = sparse_grid(shape[2], shape[2], blk, blk)[2]
        return torch.randint(0, 3, (*shape[:2], nb, nb), generator=g, device="cuda",
                             dtype=torch.int32)

    for d in (40, 80, 160):
        shape, blk = (1, 2, 256, d), 64
        nb = 4
        q, k, v = qkv(shape, bf16)
        check_sparse(results, f"d={d} all FULL", q, k, v, None,
                     torch.full((nb, nb), FULL, dtype=torch.int32, device="cuda"), blk,
                     sdpa=True)
        check_sparse(results, f"d={d} all SKIP", q, k, v, None,
                     torch.full((nb, nb), SKIP, dtype=torch.int32, device="cuda"), blk)
        keep = mixed_keep(shape, blk)
        check_sparse(results, f"d={d} mixed, -inf bias", q, k, v, neg_inf(keep),
                     block_map_from_keep(keep, blk, blk), blk)
        check_sparse(results, f"d={d} random states, finite PARTIAL bias", q, k, v,
                     torch.randn((1, 2, 256, 256), generator=g, device="cuda"),
                     states(shape, blk), blk)
        shape = (2, 3, 300, d)
        q, k, v = qkv(shape, bf16)
        keep = mixed_keep(shape, 128)
        check_sparse(results, f"d={d} mixed, N=300 (ragged, B*H > 1)", q, k, v,
                     neg_inf(keep), block_map_from_keep(keep, 128, 128), 128)
        shape = (2, 3, 512, d)
        q, k, v = qkv(shape, bf16)
        st = states(shape, 64)
        st = torch.where(torch.rand(st.shape, generator=g, device="cuda") < 0.7,
                         torch.full_like(st, PARTIAL), st)
        check_sparse(results, f"d={d} PARTIAL-heavy map, bias broadcast over batch and "
                     f"heads", q, k, v,
                     torch.randn((1, 1, 512, 512), generator=g, device="cuda"), st, 64)
        # Live tiles at both ends of each map row: the ring wraps within a
        # row (at d 160 it has 2 slots, and a PARTIAL stage takes both).
        shape = (1, 2, 1024, d)
        q, k, v = qkv(shape, bf16)
        bias = torch.randn((1, 2, 1024, 1024), generator=g, device="cuda")
        for blk, b, ends in ((128, bias, (PARTIAL, PARTIAL)), (256, None, (FULL, FULL))):
            nb = 1024 // blk
            bmap = torch.full((1, 2, nb, nb), SKIP, dtype=torch.int32, device="cuda")
            bmap[..., 0], bmap[..., -1] = ends
            check_sparse(results, f"d={d} live tiles at both ends of each map row, "
                         f"block {blk}, {'bias' if b is not None else 'no bias'}",
                         q, k, v, b, bmap, blk)
        del q, k, v, bias, bmap, keep
    for d, dv, dt in ((160, 160, f32), (256, 256, f32), (256, 256, bf16),
                      (160, 256, bf16)):
        for N in (130, 256):
            shape = (1, 2, N, d)
            q, k, v = qkv(shape, dt, dv)
            keep = mixed_keep(shape, 64)
            check_sparse(results, f"d={d} dv={dv} N={N} mixed, -inf bias", q, k, v,
                         neg_inf(keep), block_map_from_keep(keep, 64, 64), 64)
        check_sparse(results, f"d={d} dv={dv} random states, finite PARTIAL bias",
                     q, k, v, torch.randn((1, 2, N, N), generator=g, device="cuda"),
                     states(shape, 64), 64)
    del q, k, v, keep
    served = []
    for i, (shape, grid) in enumerate(UNET_QK):
        q, k, v = (correlated(shape, bf16, 140 + 3 * i + j) for j in range(3))
        nb = sparse_grid(shape[2], shape[2], 128, 128)[2]
        full = torch.full((nb, nb), FULL, dtype=torch.int32, device="cuda")
        err_full = check_sparse(results, f"{shape} all FULL (svg at T = 1, unet-sd15 "
                                f"serving shape)", q, k, v, None, full, 128, sdpa=True)
        bias, bmap = unet_served_map(grid)
        err = check_sparse(results, f"{shape} spatial_local map (constructed, unet-sd15 "
                           f"serving shape)", q, k, v, bias, bmap, 128)
        served.append({"shape": shape, "qkv": (q, k, v), "full": full, "bias": bias,
                       "bmap": bmap, "err": max(err, err_full)})
    torch.cuda.empty_cache()
    return served


def time_unet_sparse(served):
    """The sparse kernel at unet-sd15's four served calls (batch 4, 8
    heads, bf16, tensor cores): device time (torch.profiler) on the
    all-FULL map ``svg`` serves at T = 1 and on the constructed map
    (:func:`unet_served_map`), SDPA's device time without a mask and with
    the same f32 mask, the plain version (a loop over the batch rows: the
    full batch's dense scores at 16384 tokens take 34 GB), and the bound.
    Returns one dict a call."""
    import torch
    from repro_torch.kernels.sparse import ops as sparse_ops
    from repro_torch.kernels.sparse.ref import sparse_attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for call in served:
        q, k, v = call["qkv"]
        shape, d = call["shape"], call["shape"][-1]
        scale = float(1.0 / d ** 0.5)
        inst = {"shape": list(shape), "max_abs_err": call["err"],
                "tensor_cores": sparse_ops.uses_tensor_cores(q, v)}
        for name, bias, bmap in (("full", None, call["full"]),
                                 ("map", call["bias"], call["bmap"])):
            def kern():
                return sparse_ops.sparse_attention(q, k, v, bias=bias, block_map=bmap,
                                                   block_q=128, block_k=128)
            ms, host = device_time_ms(kern, "sparse_wgmma_kernel")
            # The mask in q's dtype, so that SDPA may take its fused kernels.
            mask = None if bias is None else bias.to(q.dtype)
            lib, _ = device_time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale))
            plain = cuda_time_ms(lambda: [sparse_attention_ref(
                q[b:b + 1], k[b:b + 1], v[b:b + 1], bias=bias, block_map=bmap,
                block_q=128, block_k=128, scale=scale) for b in range(q.shape[0])],
                iters=1, warmup=1)
            bound, by, flops, nbytes = sparse_bound(q, v, bias, bmap, 128)
            log(f"time sparse_attention bf16 {shape} (unet-sd15, d {d}, tensor cores "
                f"{inst['tensor_cores']}) {'all-FULL map, no bias' if bias is None else 'spatial_local map with its bias'} "
                f"({tile_shares(bmap)}): kernel device {ms:.4f} ms "
                f"({flops / ms / 1e9:.2f} TFLOP/s), host {host:.4f} ms a wrapper call; "
                f"plain {plain:.4f} ms; sdpa {'' if bias is None else 'with the mask in bf16 '}"
                f"device {lib:.4f} ms; bound {bound:.4f} ms ({by}: {flops / 1e12:.4f} "
                f"TFLOP, {nbytes / 1e6:.1f} MB); bound/kernel {bound / ms:.3f}, "
                f"kernel/sdpa {ms / lib:.3f}; {CARD}")
            inst.update({f"{name}_ms": ms, f"{name}_host_ms": host,
                         f"{name}_plain_ms": plain, f"{name}_library_ms": lib,
                         f"{name}_bound_ms": bound, f"{name}_bound_by": by})
        out.append(inst)
    served.clear()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Kernel 5: dense flash attention
# ---------------------------------------------------------------------------

# The four shapes of tests/test_kernels.py::TestFlashKernel (B, H, Nq, Nk,
# d, dv) and the two serving shapes (the vDiT's, the DiT's).
FLASH_TEST_SHAPES = ((1, 1, 128, 128, 64, 64), (2, 3, 256, 256, 32, 32),
                     (1, 2, 200, 333, 16, 48), (1, 1, 64, 512, 128, 128))
FLASH_SERVE_SHAPES = ((1, 24, 8448, 8448, 128, 128), (4, 16, 4096, 4096, 72, 72))
# (B, H, Nq, Nk, d, dv) above 128 channels, ragged Nq != Nk: d 192, d 256,
# d 256 with dv 128, and odd dims padded to 192 / 256 (d 130, dv 250).
FLASH_WIDE_SHAPES = (((1, 2, 200, 333, 192, 192), " d 192, ragged Nq != Nk"),
                     ((1, 2, 200, 333, 256, 256), " d 256, ragged Nq != Nk"),
                     ((2, 2, 130, 77, 256, 128), " d 256 dv 128, ragged Nq != Nk"),
                     ((1, 1, 100, 150, 130, 250), " d 130 dv 250 (padded), ragged"))
# gemma3-4b's global-layer head shape (8 heads of 256) at 4096 tokens.
FLASH_D256_SHAPE = (1, 8, 4096, 4096, 256, 256)


def flash_oracle(q, k, v, round_p, exact=False):
    """f32 dense softmax attention, one head at a time; ``round_p`` rounds
    the probabilities to bf16 before the PV product, where the bf16
    kernel rounds them (the row sum stays f32); ``exact`` computes in f64
    instead of f32."""
    import torch

    B, H, Nq, d = q.shape
    scale = float(1.0 / (d ** 0.5))
    wt = torch.float64 if exact else torch.float32
    out = torch.empty((B, H, Nq, v.shape[-1]), dtype=wt, device=q.device)
    for b in range(B):
        for h in range(H):
            s = torch.matmul(q[b, h].to(wt), k[b, h].to(wt).T) * scale
            p = torch.exp(s - s.amax(-1, keepdim=True))
            l = p.sum(-1, keepdim=True)
            if round_p:
                p = p.bfloat16().to(wt)
            out[b, h] = torch.matmul(p, v[b, h].to(wt)) / l
            del s, p
    return out


def check_flash(results, shape, dtype, seed, label="", amp=1.0):
    """The kernel on seeded operands of ``shape`` (B, H, Nq, Nk, d, dv);
    ``amp`` scales q and k (the extreme-logits case: logits in the
    hundreds).  Returns the max abs error."""
    import torch

    B, H, Nq, Nk, d, dv = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = (amp * torch.randn((B, H, Nq, d), generator=g, device="cuda")).to(dtype)
    k = (amp * torch.randn((B, H, Nk, d), generator=g, device="cuda")).to(dtype)
    v = torch.randn((B, H, Nk, dv), generator=g, device="cuda").to(dtype)
    return check_flash_operands(results, q, k, v, label)


def check_flash_operands(results, q, k, v, label="", slack=None, **kw):
    """The kernel against :func:`flash_oracle` at ``attn_tol`` (bf16
    rounds p where the kernel does), on the tensor cores for bf16 and the
    CUDA cores for f32; with ``slack`` (:func:`f32_logit_slack`) the
    oracle is exact and the bar is ``attn_tol`` plus the slack.  Returns
    the max abs error."""
    import torch
    from repro_torch.kernels.flash import ops as flash_ops

    (B, H, Nq, d), Nk, dv, dtype = q.shape, k.shape[2], v.shape[3], q.dtype
    out = flash_ops.flash_attention(q, k, v, **kw)
    tc = flash_ops.uses_tensor_cores(q)
    ref = flash_oracle(q, k, v, round_p=dtype == torch.bfloat16, exact=slack is not None)
    torch.cuda.synchronize()
    err = (out.to(ref.dtype) - ref).abs().max().item()
    name = str(dtype).replace("torch.", "")
    tol = attn_tol(name, ref) + (slack or 0.0)
    ok = (err <= tol and bool(torch.isfinite(out).all()) and out.shape == (B, H, Nq, dv)
          and out.dtype == dtype and tc == (dtype == torch.bfloat16))
    path = "tensor cores" if tc else "CUDA cores"
    oracle = "f32 dense" if slack is None else f"f64 dense, logit slack {slack:.3g}"
    log(f"kernel flash_attention {name:8s} q{(B, H, Nq, d)} k{(B, H, Nk, d)} "
        f"v{(B, H, Nk, dv)}{label} [{path}]: max abs err vs {oracle} {err:.3e} "
        f"(tol {tol:.3g}) {'ok' if ok else 'FAIL'}")
    results.append(ok)
    if not ok:
        raise SystemExit("flash kernel disagrees with dense attention, or took the "
                         "wrong path")
    del out, ref
    return err


def flash_checks():
    """Every flash case on seeded operands (the kernel_bench phase holds
    the kernel on its own operands too); returns the max abs error at
    FLASH_D256_SHAPE."""
    import torch

    res = []
    for dt in (torch.float32, torch.bfloat16):
        for i, shape in enumerate(FLASH_TEST_SHAPES):
            check_flash(res, shape, dt, 50 + i)
        check_flash(res, (1, 1, 128, 128, 32, 32), dt, 55, " extreme logits (q, k x30)",
                    amp=30.0)
        check_flash(res, (2, 2, 77, 130, 20, 7), dt, 56, " odd head dims")
        check_flash(res, (1, 3, 200, 333, 72, 40), dt, 60, " ragged Nq != Nk, d != dv")
    check_flash(res, FLASH_SERVE_SHAPES[0], torch.bfloat16, 57, " (vDiT serving shape)")
    check_flash(res, FLASH_SERVE_SHAPES[1], torch.bfloat16, 58, " (dit-xl2 serving shape)")
    # Head dims above 128 (slice 17): the wide instantiations, both paths.
    for dt in (torch.float32, torch.bfloat16):
        for i, (shape, label) in enumerate(FLASH_WIDE_SHAPES):
            check_flash(res, shape, dt, 64 + i, label)
    d256_err = check_flash(res, FLASH_D256_SHAPE, torch.bfloat16, 68,
                           " (gemma3-4b's global-layer head shape, unmasked)")
    torch.cuda.empty_cache()
    log(f"kernel flash_attention: {sum(res)}/{len(res)} cases within tolerance")
    return d256_err


def flash_bound(B, H, Nq, Nk, d, dv, dtype_name):
    """(bound ms, 'bytes' or 'operations', flops, bytes) of one call
    (``launch.roofline.flash_work``)."""
    from repro_torch.launch import roofline

    w = roofline.flash_work(B, H, Nq, Nk, d, dv, dtype_name)
    return (*w.bound(), w.ops, w.nbytes)


def time_flash(shape, label):
    """:func:`time_flash_operands` on seeded bf16 operands of ``shape``."""
    import torch

    B, H, Nq, Nk, d, dv = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(59)
    q = torch.randn((B, H, Nq, d), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, H, Nk, d), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, H, Nk, dv), generator=g, device="cuda").bfloat16()
    out = time_flash_operands(q, k, v, label)
    del q, k, v
    torch.cuda.empty_cache()
    return out


def time_flash_operands(q, k, v, label, iters=(5, 3, 10), **kw):
    """Kernel, plain version and ``scaled_dot_product_attention`` (the
    library yardstick; the port never calls it) on the same operands;
    ``iters`` for each of the three."""
    import torch
    from repro_torch.kernels.flash.ops import flash_attention
    from repro_torch.kernels.flash.ref import attention_ref

    (B, H, Nq, d), Nk, dv = q.shape, k.shape[2], v.shape[3]
    name = str(q.dtype).replace("torch.", "")
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, **kw), iters=iters[0], warmup=1)
    plain = cuda_time_ms(lambda: attention_ref(q, k, v), iters=iters[1], warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = cuda_time_ms(lambda: sdpa(q, k, v, scale=float(1.0 / d ** 0.5)),
                       iters=iters[2], warmup=1)
    bound, by, flops, nbytes = flash_bound(B, H, Nq, Nk, d, dv, name)
    log(f"time flash_attention {name} {(B, H, Nq, d)} ({label}): kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
        f"bound {bound:.4f} ms ({by}: {flops / 1e12:.4f} TFLOP, {nbytes / 1e6:.1f} MB)")
    torch.cuda.empty_cache()
    return ms, plain, lib, bound, by


# ---------------------------------------------------------------------------
# Kernel 6: single-axis pair snap
# ---------------------------------------------------------------------------

# tests/test_kernels.py::TestReuseSnapKernel's cases (B, H, N, d), plus
# head dims that take the element-wise variant (bf16 d 20, f32 d 6).
SNAP_SHAPES = ((2, 2, 256, 16), (2, 2, 300, 32), (2, 2, 64, 128), (2, 2, 64, 20),
               (2, 2, 66, 6))
SNAP_SERVE_SHAPE = (1, 24, 8448, 128)


def check_snap(results, shape, dtype, theta, seed):
    """The kernel bit for bit against its plain version on the same card
    tensors; the even half untouched and never masked."""
    import torch
    from repro_torch.kernels.reuse_mask.ops import reuse_snap
    from repro_torch.kernels.reuse_mask.ref import reuse_snap_plain

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    snapped, mask = reuse_snap(x, theta)
    ref_s, ref_m = reuse_snap_plain(x, theta)
    torch.cuda.synchronize()
    ok = (bits_equal(snapped, ref_s) and torch.equal(mask, ref_m)
          and bits_equal(snapped[..., 0::2, :].contiguous(), x[..., 0::2, :].contiguous())
          and not bool(mask[..., 0::2, :].any()))
    frac = mask[..., 1::2, :].float().mean().item()
    name = str(dtype).replace("torch.", "")
    log(f"kernel reuse_snap {name:8s} x{tuple(shape)} theta={theta}: bit-equal={ok} "
        f"snapped share of the odd half {frac:.4f}")
    results.append(ok)
    if not ok:
        raise SystemExit("reuse_snap kernel disagrees with its plain version")
    return (snapped.float() - ref_s.float()).abs().max().item()


def snap_checks():
    """Every reuse_snap case; returns the serving shape's max abs error."""
    import torch

    res = []
    for dt in (torch.bfloat16, torch.float32):
        for i, shape in enumerate(SNAP_SHAPES):
            for theta in (0.0, 0.3, 10.0):
                check_snap(res, shape, dt, theta, 70 + i)
    serve_err = check_snap(res, SNAP_SERVE_SHAPE, torch.bfloat16, 0.3, 76)
    log(f"kernel reuse_snap: {sum(res)}/{len(res)} cases bit-equal")
    return serve_err


def snap_composite(x, th):
    """The pair snap as a short chain of eager PyTorch ops (no single
    library call computes it): the odd half's Δ, compare and select
    written into a copy of x, and the mask."""
    import torch

    e, o = x[..., 0::2, :], x[..., 1::2, :]
    m = (o - e).abs_().mul_(0.5) < th
    out = x.clone()
    out[..., 1::2, :] = torch.where(m, e, o)
    mask = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
    mask[..., 1::2, :] = m
    return out, mask


def time_snap(flush):
    import torch
    from repro_torch.kernels.reuse_mask.ops import reuse_snap
    from repro_torch.kernels.reuse_mask.ref import reuse_snap_plain
    from repro_torch.launch import roofline

    g = torch.Generator(device="cuda")
    g.manual_seed(77)
    x = torch.randn(SNAP_SERVE_SHAPE, generator=g, device="cuda").bfloat16()
    th = torch.tensor(0.3, device="cuda").bfloat16()
    ms, host = device_time_ms(lambda: reuse_snap(x, 0.3), "snap_vec_kernel", flush=flush)
    wrap = cuda_time_ms(lambda: reuse_snap(x, 0.3), iters=20)
    plain = cuda_time_ms(lambda: reuse_snap_plain(x, 0.3), iters=10)
    comp = cuda_time_ms(lambda: snap_composite(x, th), iters=10)
    work = roofline.snap_work(x.shape, x.element_size())
    bound, by = work.bound()
    nbytes = work.nbytes
    log(f"time reuse_snap bf16 {SNAP_SERVE_SHAPE}: device {ms:.4f} ms a call (L2 "
        f"flushed; {nbytes / ms / 1e6:.1f} GB/s, {bound / ms:.3f} of the bound), host "
        f"{host:.4f} ms a wrapper call, wrapper time back to back {wrap:.4f} ms; plain "
        f"{plain:.4f} ms, eager composite {comp:.4f} ms (no single PyTorch call), bound "
        f"{bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB); {CARD}")
    del x
    return ms, host, plain, bound, by


# ---------------------------------------------------------------------------
# Entry points without a serving path: the kernel micro-bench and the
# public pair-snap wrapper
# ---------------------------------------------------------------------------


KB_WIDE = (1, 24, 8192, 128)  # the sparse sweep at the vDiT's width: (8, 32, 32) x 24 x 128


def kernel_bench_phase():
    """The port's kernel micro-bench (``python -m
    repro_torch.launch.kernel_bench``) at the reference's defaults, then
    its sparse sweep at the vDiT's serving width (grid (8, 32, 32), 24
    heads of 128), with the launch counters set to 0 just before and read
    just after: the flash, sparse and fused_reuse kernels must launch.
    The first flash call and the first sparse call on each map of each
    sweep keep their operands; afterwards each is held against its exact
    oracle (f32, as the sweep launches them, on the CUDA cores), and the
    flash kernel is timed on the wide sweep's operands.  Returns the
    counts and (max abs err, ms, plain ms, library ms, bound ms, bound by)
    of flash at that width."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.sparse.ops import PARTIAL
    from repro_torch.launch import kernel_bench

    flash_calls, sparse_calls = {}, {}

    def keep(store, key):
        def make(orig):
            def f(q, k, v, **kw):
                store.setdefault(key(q, kw), (q, k, v, kw))
                return orig(q, k, v, **kw)
            return f
        return make

    swept = []

    def sweep(orig):
        def f(*a, **kw):
            swept.append(orig(*a, **kw))
            return swept[-1]
        return f

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with wrapped(kernel_bench, "flash_attention",
                 keep(flash_calls, lambda q, kw: tuple(q.shape))), \
            wrapped(kernel_bench, "sparse_attention",
                    keep(sparse_calls, lambda q, kw: (tuple(q.shape),
                                                      kw["block_map"].data_ptr()))), \
            wrapped(kernel_bench, "static_pattern_sweep", sweep):
        kernel_bench.main([])
        wide = kernel_bench.sparse_backend_sweep(grid=(8, 32, 32), d=128, heads=24)
        log(kernel_bench.sparse_row(wide))
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"kernel_bench: launches {counts}; {time.perf_counter() - t0:.1f}s; {CARD}")
    if any(counts[n] <= 0 for n in ("flash_attention", "sparse_attention",
                                    "fused_reuse")):
        raise SystemExit(f"kernel_bench: a kernel of the path never launched: {counts}")
    if len(swept) != 1 or not swept[0]["map_stable"]:
        raise SystemExit(f"kernel_bench[static_pattern_sweep]: {swept}")
    if KB_WIDE not in flash_calls or len(sparse_calls) != 4:
        raise SystemExit(f"kernel_bench: calls kept {list(flash_calls)}, "
                         f"{len(sparse_calls)} sparse")

    res = []
    for q, k, v, kw in sparse_calls.values():
        bmap, blk = kw["block_map"], kw["block_q"]
        which = "all-PARTIAL map" if bool((bmap == PARTIAL).all()) else "svg map"
        check_sparse(res, f"kernel_bench operands, {which}", q, k, v, kw["bias"], bmap,
                     blk, slack=f32_logit_slack(q, k, v))
    q, k, v, kw = next(c for c in sparse_calls.values() if tuple(c[0].shape) == KB_WIDE
                       and not bool((c[3]["block_map"] == PARTIAL).all()))
    time_sparse_f32(q, k, v, kw)
    del q, k, v, kw
    sparse_calls.clear()
    torch.cuda.empty_cache()
    errs = {}
    for shape, (q, k, v, kw) in flash_calls.items():
        errs[shape] = check_flash_operands(res, q, k, v, " (kernel_bench operands)",
                                           slack=f32_logit_slack(q, k, v), **kw)
    log(f"kernel_bench: {sum(res)}/{len(res)} kernel calls on the sweeps' own operands "
        f"within tolerance")
    q, k, v, kw = flash_calls.pop(KB_WIDE)
    flash_calls.clear()
    timed = time_flash_operands(q, k, v, "kernel_bench operands, the sweep's dense "
                                "anchor", iters=(3, 2, 3), **kw)
    del q, k, v
    torch.cuda.empty_cache()
    return counts, (errs[KB_WIDE],) + timed


def time_sparse_f32(q, k, v, kw):
    """The sparse kernel's f32 CUDA-core path on the wide sweep's svg-map
    call (its own operands, bias and map), its bound at the f32 peak, and
    ``scaled_dot_product_attention`` in f32 with the same additive mask
    (the library yardstick; the port never calls it)."""
    import torch
    from repro_torch.kernels.sparse.ops import sparse_attention

    ms = cuda_time_ms(lambda: sparse_attention(q, k, v, **kw), iters=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=kw["bias"],
                                    scale=float(1.0 / q.shape[-1] ** 0.5)),
                       iters=3, warmup=1)
    bound, by, flops, nbytes = sparse_bound(q, v, kw["bias"], kw["block_map"],
                                            kw["block_q"])
    log(f"time sparse_attention float32 {tuple(q.shape)} block {kw['block_q']} "
        f"(kernel_bench operands, svg map, {tile_shares(kw['block_map'])}; CUDA cores): "
        f"kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), sdpa f32 with the same "
        f"mask {lib:.4f} ms, bound {bound:.4f} ms ({by}: {flops / 1e12:.4f} TFLOP at "
        f"the f32 peak, {nbytes / 1e9:.3f} GB); {CARD}")
    torch.cuda.empty_cache()


def snap_phase(calls=4):
    """The public ``reuse_snap`` wrapper, called as its only callers in
    the reference (its kernel tests) call it, on an operand of the vDiT's
    serving width in t-major pair order (``pair_major_order``), so that
    each pair is a token and its partner in the next frame, at the Eq. 4
    thresholds 0.2 .. 0.5; the counters set to 0 just before and read
    just after."""
    import torch
    from repro_torch.core.collapse import pair_major_order
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.reuse_mask.ops import reuse_snap

    grid = (8, 32, 32)
    x = correlated((1, 24, 8 * 32 * 32, 128), torch.bfloat16, 78, noise=0.3)
    x = x[:, :, torch.as_tensor(pair_major_order(grid, "t"), device="cuda")].contiguous()
    torch.cuda.synchronize()
    reset_launch_counts()
    fracs = []
    for theta in torch.linspace(0.2, 0.5, calls).tolist():
        _, mask = reuse_snap(x, theta)
        fracs.append(mask[..., 1::2, :].float().mean().item())
    counts = launch_counts()
    log(f"snap[reuse_snap]: x{tuple(x.shape)} t-major, thetas 0.2..0.5: snapped share of "
        f"the odd half {[round(f, 4) for f in fracs]}; launches {counts}")
    if counts["reuse_snap"] != calls or any(
            n != "reuse_snap" and c for n, c in counts.items()):
        raise SystemExit(f"snap[reuse_snap]: unexpected launches {counts}")
    del x
    return counts


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


def depth_view(arch, model, layers: int):
    """(arch, model) cut to the first ``layers`` blocks of ``model``: a
    view sharing its weights (no new init), with the config's depth
    cut to match."""
    import copy

    from torch import nn

    if layers >= len(model.blocks):
        return arch, model
    view = copy.copy(model)
    view._modules = dict(model._modules)
    view.blocks = nn.ModuleList(list(model.blocks)[:layers])
    view.cfg = dataclasses.replace(model.cfg, num_layers=layers)
    return dataclasses.replace(arch, model=view.cfg), view


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


def vdit_plain_versions():
    """``(module, name)`` of the plain versions of the kernels a served
    vDiT runs (ripple, fused_reuse and the sparse kernel), for
    :func:`plain_guard`."""
    from repro_torch.core import reuse as reuse_lib
    from repro_torch.kernels.reuse_mask import ops as reuse_ops
    from repro_torch.kernels.ripple import ops as ripple_ops
    from repro_torch.kernels.sparse import ops as sparse_ops

    return ((reuse_ops, "fused_reuse_ref"), (reuse_lib, "compute_reuse"),
            (ripple_ops, "ripple_attention_ref"), (sparse_ops, "sparse_attention_ref"))


@contextlib.contextmanager
def plain_guard(plain_absent):
    """Count the calls on CUDA tensors of each function ``(module, name)``
    of ``plain_absent`` (a kernel's plain version) for the duration;
    yields the counts by ``module.name``."""
    import torch

    plain = {f"{mod.__name__}.{name}": 0 for mod, name in plain_absent}

    def counting(key):
        def make(orig):
            def f(*a, **kw):
                if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                    plain[key] += 1
                return orig(*a, **kw)
            return f
        return make

    with contextlib.ExitStack() as ctx:
        for mod, name in plain_absent:
            ctx.enter_context(wrapped(mod, name, counting(f"{mod.__name__}.{name}")))
        yield plain


def serve_phase(label, arch, shape, model, *, policy=None, launched=(), absent=(),
                requests=SERVE_REQUESTS, plain_absent=(), aux=None, latents=None,
                guardrail=False, metrics=None):
    """Serve ``requests`` requests in one batch through the port's
    DiffusionEngine with the launch counters set to 0 just before and
    read just after; each kernel in ``launched`` must have run, none in
    ``absent``, and no function ``(module, name)`` of ``plain_absent``
    (a kernel's plain version) may run on a CUDA tensor.  A cache-aware
    sampler's counters (its ``(latents, aux)`` return) go into ``aux``;
    each request's latents go into ``latents`` by seed.  With
    ``guardrail`` the sampler carries the sentinels and the engine a
    degradation ladder, as the launcher serves; the engine's counters
    (the ladder's too) go into ``metrics``."""
    import numpy as np
    import torch
    from repro_torch.core.guardrail import DegradationLadder
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import attention_plans, build_sampler
    from repro_torch.launch.workloads import mixed_request_stream
    from repro_torch.serving.engine import DiffusionEngine

    def make(pol=None):
        return build_sampler(arch, shape, model, policy=pol or policy,
                             sentinel=guardrail)

    sample_fn, lat_shape = make()
    plans = "; ".join(f"{n} tokens x d {hd}: {plan.summary()}" for n, hd, plan in
                      attention_plans(arch, shape, on_cuda=True, policy=policy))
    log(f"serve[{label}]: plan {plans}; ripple {arch.ripple}"
        f"{'' if policy is None else f', policy {policy}'}")
    def sampler(noise, txt, seeds):
        out = sample_fn(noise, txt, seeds)
        if isinstance(out, tuple) and aux is not None:
            aux.update({k: int(v) for k, v in out[1].items()})
        return out

    if guardrail:  # a degraded bucket gets a sampler under its new policy
        def factory(shp, steps, pol=None, reuse_every=None, stream_every=None):
            return sampler if pol in (None, policy) else make(pol)[0]
    else:
        def factory(shp, steps):
            return sampler
    engine = DiffusionEngine(factory, device="cuda", max_batch=requests,
                             guardrail=DegradationLadder() if guardrail else None)
    traffic = mixed_request_stream(arch, (shape,), requests, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for _, req in traffic:  # all queued before the worker starts: one batch
        engine.submit(req)
    with plain_guard(plain_absent) as plain:
        engine.start()
        try:
            results = [engine.result(req.request_id) for _, req in traffic]
        finally:
            engine.stop()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if metrics is not None:
        metrics.update(engine.metrics())
    for r in results:
        log(f"serve[{label}]: request {r.request_id} latency {r.latency_s:.3f}s "
            f"(batch {r.batch_index} of {requests} served in "
            f"{r.walltime_s:.3f}s); latents {r.latents.shape}; {CARD}")
        if r.latents.shape != lat_shape:
            raise SystemExit(f"latents {r.latents.shape} != {lat_shape}")
        if not np.isfinite(r.latents).all():
            raise SystemExit("served latents are not finite")
    if latents is not None:
        latents.update({req.seed: r.latents for (_, req), r in zip(traffic, results)})
    log(f"serve[{label}]: launches {counts}; peak device memory {peak:.2f} GiB; {CARD}")
    if len({r.batch_index for r in results}) != 1:
        raise SystemExit(f"serve[{label}]: the requests did not share one batch")
    if any(counts[n] <= 0 for n in launched):
        raise SystemExit(f"serve[{label}]: a kernel of the path never launched: {counts}")
    if any(counts[n] != 0 for n in absent):
        raise SystemExit(f"serve[{label}]: a kernel off the path launched: {counts}")
    if plain:
        log(f"serve[{label}]: plain versions called on the card: {plain}")
        if any(plain.values()):
            raise SystemExit(f"serve[{label}]: a plain version ran on the card: {plain}")
    return counts, results, lat_shape


def serve_ripple(arch, shape, model, label="ripple", **phase):
    """The ripple policy (PR 11's path): fused Δ-check + pair collapse.
    Reads the policy's snap masks at step 10 (grid tokens only) and the
    share of ripple-kernel tiles that collapse there, by shadowing the
    policy's methods on the registered instance and the kernel wrapper
    for this run only; every ripple call's (dtype, d, dv, tensor cores)
    is counted.  ``phase`` goes to :func:`serve_phase`."""
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels.ripple import ops as ripple_ops

    pol = get_policy("ripple")
    snaps = {"q": [], "k": [], "qt": [], "kt": []}
    current = {"step": None}
    paths = {}  # (dtype, N, d, dv, tensor cores) -> ripple calls

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
            key = (str(q.dtype).replace("torch.", ""), q.shape[-2], q.shape[-1],
                   v.shape[-1], ripple_ops.uses_tensor_cores(q, v))
            paths[key] = paths.get(key, 0) + 1
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
        f"ripple tiles collapsed there: Q {qt:.4f} K {kt:.4f}; ripple calls (dtype, N, "
        f"d, dv, tensor cores): calls {sorted(paths.items())}")
    if q_snap <= 0 or k_snap <= 0:
        raise SystemExit("no snapping at step 10")
    return counts, lat_shape, paths


CACHE_EVERY = 4   # serve[ripple-cache] / serve[svg-cache]: reuse_every
CACHE_STEPS = 24  # refreshes on steps 0, 4, ..., 20 and 23; hits after 12 snap


def cache_schedule(arch, steps):
    """(refresh steps, hit steps, hit steps whose plan snaps) of a
    ``steps``-step trajectory under the arch's cadence (no drift guard):
    a hit replays the plan of the refresh before it, which snaps where
    that step's θ is above 0."""
    from repro_torch.core.schedule import threshold_schedule

    every = arch.ripple.reuse_every
    refresh = [s for s in range(steps) if s % every == 0 or s == steps - 1]
    hits = [s for s in range(steps) if s not in refresh]
    theta = threshold_schedule(arch.ripple, steps)
    snapping = [s for s in hits if theta[max(r for r in refresh if r < s)] > 0]
    return refresh, hits, snapping


def check_cache_counters(label, arch, refresh, hits, aux, layers, batch):
    """The sampler's hit and refresh counters against the cadence: per
    (layer, batch, head) cell, one a step."""
    cells = layers * batch * arch.model.num_heads
    want = {"cache_hits": len(hits) * cells, "cache_refreshes": len(refresh) * cells}
    log(f"serve[{label}]: decision cache: {aux.get('cache_hits')} hits / "
        f"{aux.get('cache_refreshes')} refreshes (want {want['cache_hits']} / "
        f"{want['cache_refreshes']}: {len(hits)} hits and {len(refresh)} refreshes per "
        f"(layer, batch, head) cell; refresh steps {refresh})")
    if any(aux.get(k) != v for k, v in want.items()):
        raise SystemExit(f"serve[{label}]: decision-cache counters {aux} != {want}")


def serve_ripple_cache(arch, shape, model):
    """The ripple policy under the decision cache (``reuse_every``
    ``CACHE_EVERY``, no drift guard) over ``CACHE_STEPS`` steps: the
    fused_reuse kernel (with its source map) launches on refresh steps
    only, 2 a layer, the ripple kernel every step; neither the kernel's
    plain version nor the host pipeline runs on the card.  Records the
    replayed Q snap fraction (grid tokens) on every hit step by shadowing
    the policy's ``apply_decision`` for this run only."""
    import torch
    from repro_torch.core import reuse as reuse_lib
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels.reuse_mask import ops as reuse_ops

    pol = get_policy("ripple")
    current = {"step": None}
    replayed = {}

    def thetas_for(orig):
        def f(cfg, step, total_steps, thetas=None):
            current["step"] = step
            return orig(cfg, step, total_steps, thetas)
        return f

    def apply_decision(orig):
        def f(q, k, cached, **kw):
            d = orig(q, k, cached, **kw)
            s, n = kw["grid_slice"]
            replayed.setdefault(current["step"], []).append(
                d.q_mask.narrow(-2, s, n).float().mean())
            return d
        return f

    layers, steps = arch.model.num_layers, shape.steps
    refresh, hits, snapping = cache_schedule(arch, steps)
    aux = {}
    with wrapped(pol, "thetas_for", thetas_for), \
            wrapped(pol, "apply_decision", apply_decision):
        counts, results, lat_shape = serve_phase(
            "ripple-cache", arch, shape, model, launched=("fused_reuse", "ripple_attention"),
            absent=("sparse_attention",), aux=aux,
            plain_absent=((reuse_ops, "fused_reuse_ref"), (reuse_lib, "compute_reuse")))
    want = {"fused_reuse": len(refresh) * layers * 2, "ripple_attention": steps * layers}
    if any(counts[n] != c for n, c in want.items()):
        raise SystemExit(f"serve[ripple-cache]: launches {counts}, want {want}")
    check_cache_counters("ripple-cache", arch, refresh, hits, aux, layers, SERVE_REQUESTS)
    fracs = {s: torch.stack(v).mean().item() for s, v in sorted(replayed.items())}
    log(f"serve[ripple-cache]: replayed Q snap fraction on the hit steps "
        f"{ {s: round(f, 4) for s, f in fracs.items()} }; the plans of steps "
        f"{snapping} snap")
    if sorted(fracs) != hits or any(fracs[s] <= 0 for s in snapping):
        raise SystemExit("serve[ripple-cache]: the hit steps did not replay the snaps")
    return counts, lat_shape


def serve_svg_cache(arch, shape, model):
    """The svg policy under the decision cache: the head classification
    and mask building (``svg_logit_bias``) run on the refresh steps only,
    the sparse kernel on every step; 1 request."""
    import torch
    from repro_torch.core import policy as policy_lib

    pol = policy_lib.get_policy("svg")
    current = {"step": None}
    built = []

    def thetas_for(orig):
        def f(cfg, step, total_steps, thetas=None):
            current["step"] = step
            return orig(cfg, step, total_steps, thetas)
        return f

    def bias(orig):
        def f(*a, **kw):
            built.append(current["step"])
            return orig(*a, **kw)
        return f

    layers, steps = arch.model.num_layers, shape.steps
    refresh, hits, _ = cache_schedule(arch, steps)
    aux = {}
    with wrapped(pol, "thetas_for", thetas_for), \
            wrapped(policy_lib, "svg_logit_bias", bias):
        counts, results, _ = serve_phase(
            "svg-cache", arch, shape, model, policy="svg", launched=("sparse_attention",),
            absent=("ripple_attention", "fused_reuse"), requests=1, aux=aux)
    log(f"serve[svg-cache]: mask building on steps {sorted(set(built))} "
        f"({len(built)} calls); sparse_attention launches {counts['sparse_attention']}")
    if sorted(set(built)) != refresh or len(built) != len(refresh) * layers \
            or counts["sparse_attention"] != steps * layers:
        raise SystemExit(f"serve[svg-cache]: mask building {built} or sparse launches "
                         f"{counts} off the cadence {refresh}")
    check_cache_counters("svg-cache", arch, refresh, hits, aux, layers, 1)
    torch.cuda.empty_cache()
    return counts


def profile_cache(arch, model, lat_shape, refresh_step, hit_step, total):
    """One forward at a refresh step (no plan yet: the layers decide, the
    fused kernel writing its source map) and one at a hit step (the plans
    of that refresh replayed), with the snap step (``snap_operand`` on the
    refresh, ``replay_snap`` on the hit) as the family ``snap``."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.kernels.ripple import ops as ripple_ops

    fams = {"ripple_attention": "ripple", "fused_reuse": "fused_reuse"}
    ann = [(ripple_ops, "block_flags", "ripple_flags"),
           (policy_lib, "snap_operand", "snap"), (policy_lib, "replay_snap", "snap")]
    layers = arch.model.num_layers
    primed = [None] * layers
    out = {"refresh": profile_forward(
        "ripple-cache refresh", arch, model, lat_shape, fams, annotate=ann,
        total=total, step=refresh_step, make_state=lambda: [None] * layers,
        keep_state=primed)}
    out["hit"] = profile_forward("ripple-cache hit", arch, model, lat_shape, fams,
                                 annotate=ann, total=total, step=hit_step,
                                 make_state=lambda: primed)
    if out["hit"]["fused_reuse"] != 0:
        raise SystemExit("profile[ripple-cache hit]: the hit step launched fused_reuse")
    log(f"profile[ripple-cache]: snap step a forward, refresh (step {refresh_step}) "
        f"{out['refresh']['snap']:.3f} ms, hit (step {hit_step}) {out['hit']['snap']:.3f} "
        f"ms (hit/refresh {out['hit']['snap'] / out['refresh']['snap']:.3f}); the forward "
        f"{out['refresh']['wall']:.3f} / {out['hit']['wall']:.3f} ms; {CARD}")
    return out


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
    cores; then one forward at step 10 is profiled.  Returns the run's
    launch counts, the profile and the steps a request."""
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
    prof = profile_forward("dit-xl2", arch, model, lat_shape,
                           {"ripple_attention": "ripple", "fused_reuse": "fused_reuse",
                            "adaln": "adaln"}, annotate=ripple_ranges(),
                           batch=DIT_REQUESTS, total=shape.steps)
    del model
    torch.cuda.empty_cache()
    return counts, prof, shape.steps


def serve_unet():
    """unet-sd15 at full width and depth (ch 320, ch_mult 1-2-4-4, 2 res
    blocks a level, 8 heads, text context 77 x 768) on gen_1024: 4
    requests in one batch, 50 DDIM steps, through the ripple policy.  The
    fused_reuse and ripple kernels must launch on every self-attention
    call (16 a forward), the ripple kernel on the tensor cores at each
    level's head dim (40, 80, 160), and the sparse kernel not at all; then
    one forward at step 10 is profiled with the convolutions and the
    GroupNorms as families of their own.  Returns the launch counts and
    the ripple kernel's launches by (tokens, head dim), both from the
    wrappers' counters."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ripple import ops as ripple_ops
    from repro_torch.launch.serve import serving_shape
    from repro_torch.launch.workloads import attention_shapes
    from repro_torch.models import conv as conv_lib
    from repro_torch.models.params import init_unet

    arch = get_config("unet-sd15")
    shape = serving_shape(arch, UNET_SHAPE, smoke=False)
    m = arch.model
    log(f"serve: unet-sd15 full width and depth ch={m.ch} ch_mult={m.ch_mult} "
        f"n_res_blocks={m.n_res_blocks} attn_res={m.attn_res} heads={m.num_heads} "
        f"context={m.ctx_tokens}x{m.ctx_dim}; {shape.name}: img_res {shape.img_res}, "
        f"latents {shape.img_res // 8}x{shape.img_res // 8}x{m.in_channels}, "
        f"self-attention (tokens, head dim) {attention_shapes(arch, shape)}, "
        f"{shape.steps} DDIM steps, {UNET_REQUESTS} requests; no cuts")
    t0 = time.perf_counter()
    model = init_unet(m, seed=0, device="cuda", dtype=torch.bfloat16, zero_init=False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: {n_params / 1e9:.3f} B params (bf16, every leaf drawn from a seeded "
        f"generator, the zero-initialised biases too) in "
        f"{time.perf_counter() - t0:.1f}s")
    calls = 1 + sum(len(level.attn) for level in (*model.down, *model.up))
    counts, lat_shape, paths = serve_ripple(
        arch, shape, model, "unet-sd15", requests=UNET_REQUESTS,
        launched=("fused_reuse", "ripple_attention"))
    by_shape = dict(ripple_ops.launches_by_shape)  # read with ``counts``
    want = {"ripple_attention": calls * shape.steps, "fused_reuse": 2 * calls * shape.steps}
    dims = sorted({d for _, _, d, _, _ in paths})
    log(f"serve[unet-sd15]: {calls} self-attention calls a forward; launches "
        f"{ {n: counts[n] for n in want} } (expected {want}); ripple head dims {dims}")
    if any(counts[n] != c for n, c in want.items()):
        raise SystemExit("serve[unet-sd15]: a self-attention call missed a kernel")
    if dims != [40, 80, 160] or not all(tc for *_, tc in paths):
        raise SystemExit("serve[unet-sd15]: the ripple kernel left the tensor cores "
                         "or missed a level")
    log(f"serve[unet-sd15]: ripple launches by (tokens, head dim) {sorted(by_shape.items())}")
    if sum(by_shape.values()) != counts["ripple_attention"]:
        raise SystemExit("serve[unet-sd15]: ripple launches by shape do not add up")
    profile_forward("unet-sd15", arch, model, lat_shape,
                    {"ripple_attention": "ripple", "fused_reuse": "fused_reuse"},
                    annotate=ripple_ranges() + [(conv_lib, "conv2d", "conv"),
                                                (conv_lib, "groupnorm", "groupnorm")],
                    batch=UNET_REQUESTS, total=shape.steps)
    del model
    torch.cuda.empty_cache()
    return counts, by_shape


UNET_SVG_REQUESTS = 2  # svg's dense (B, 8, N, N) f32 bias: 17.2 GB at batch 2
UNET_SVG_STEPS = 20    # of gen_1024's 50 DDIM steps (slice 20's cut)


def sparse_recorder(shapes, maps=None, biases=None):
    """A maker for :func:`wrapped` that adds each sparse-wrapper call's
    (tokens, head dim, tensor cores) to the set ``shapes``, keeps the
    first block map of each distinct map tensor in ``maps`` and records
    whether each call carried a bias in ``biases``.  It counts nothing:
    the launches are the wrapper's own counts."""
    from repro_torch.kernels.sparse import ops as sparse_ops

    def make(orig):
        def f(q, k, v, **kw):
            shapes.add((q.shape[-2], q.shape[-1], sparse_ops.uses_tensor_cores(q, v)))
            bm = kw.get("block_map")
            if maps is not None and bm is not None:
                maps.setdefault((bm.data_ptr(), tuple(bm.shape)), bm)
            if biases is not None:
                biases.append(kw.get("bias") is not None)
            return orig(q, k, v, **kw)
        return f
    return make


def map_shares(maps):
    """(FULL, PARTIAL, SKIP) shares over the distinct maps kept by
    :func:`sparse_recorder` (each head's map once)."""
    import torch

    c = sum(tile_counts(m).reshape(-1, 3).sum(0).double() for m in maps.values())
    return tuple((c / c.sum()).tolist()) if torch.is_tensor(c) else (0.0, 0.0, 0.0)


def serve_unet_svg():
    """unet-sd15 at full width and depth (ch 320, 8 heads, text context 77 x
    768) on gen_1024 under ``--policy svg``, 50 DDIM steps, 2 requests in
    one batch (the reference's dense (B, 8, N, N) f32 bias takes 17.2 GB
    at the 128² level at batch 2, 34.4 GB at the shape's batch 4: cut to
    2).  Every one of the 16 self-attention calls a forward goes through
    the sparse kernel, on the tensor cores at its level's head dim (40, 80,
    160); fused_reuse and ripple never launch.  On a T = 1 grid svg's
    spatial mask keeps every token, so every map is all-FULL.  Returns the
    launch counts and the sparse launches by (tokens, head dim), as the
    wrapper counted them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.sparse import ops as sparse_ops
    from repro_torch.launch.serve import serving_shape
    from repro_torch.models.params import init_unet

    arch = get_config("unet-sd15")
    shape = serving_shape(arch, UNET_SHAPE, smoke=False, steps=UNET_SVG_STEPS)
    log(f"serve: unet-sd15 full width and depth under svg, {shape.name}, "
        f"{shape.steps} DDIM steps, {UNET_SVG_REQUESTS} requests; cuts: batch 4 -> "
        f"{UNET_SVG_REQUESTS} (the dense f32 bias), steps 50 -> {UNET_SVG_STEPS}")
    model = init_unet(arch.model, seed=0, device="cuda", dtype=torch.bfloat16,
                      zero_init=False)
    calls = 1 + sum(len(level.attn) for level in (*model.down, *model.up))
    shapes, maps = set(), {}
    with wrapped(sparse_ops, "sparse_attention", sparse_recorder(shapes, maps)):
        counts, _, _ = serve_phase(
            "unet-svg", arch, shape, model, policy="svg", requests=UNET_SVG_REQUESTS,
            launched=("sparse_attention",), absent=("ripple_attention", "fused_reuse"))
    by_shape = dict(sparse_ops.launches_by_shape)  # read with ``counts``
    want = calls * shape.steps
    dims = sorted({d for _, d, _ in shapes})
    full, partial, skip = map_shares(maps)
    log(f"serve[unet-svg]: {calls} self-attention calls a forward; sparse launches "
        f"{counts['sparse_attention']} (expected {want}), by (tokens, head dim) "
        f"{sorted(by_shape.items())}; calls at (tokens, head dim, tensor cores) "
        f"{sorted(shapes)}; tile shares full {full:.4f} partial {partial:.4f} "
        f"skip {skip:.4f}")
    if counts["sparse_attention"] != want:
        raise SystemExit("serve[unet-svg]: a self-attention call missed the kernel")
    if sum(by_shape.values()) != counts["sparse_attention"]:
        raise SystemExit("serve[unet-svg]: sparse launches by shape do not add up")
    if dims != [40, 80, 160] or not all(tc for *_, tc in shapes):
        raise SystemExit("serve[unet-svg]: the sparse kernel left the tensor cores "
                         "or missed a level")
    if full != 1.0:
        raise SystemExit("serve[unet-svg]: a T = 1 svg map is not all-FULL")
    del model
    torch.cuda.empty_cache()
    return counts, by_shape


# ---------------------------------------------------------------------------
# flux-dev: the MMDiT's joint attention through fused_reuse and ripple
# ---------------------------------------------------------------------------

FLUX_SHAPE = "gen_1024"   # (128, 128, 16) latents: a (1, 64, 64) grid
FLUX_REQUESTS = 4         # the shape's batch
FLUX_OFF_STEPS = 6        # serve[flux-dev ripple off]: 12 -> 6 Euler steps
FLUX_GRID = (1, 64, 64)
FLUX_SNAP = (FLUX_REQUESTS, 24, 64 * 64, 128)  # flux's Q/K grid tokens
FLUX_TEXT = (512, 0)                           # 512 text tokens before them
FLUX_LAUNCHER_CUT = ("model.n_double_blocks=2", "model.n_single_blocks=4")
FLUX_LAUNCHER_ARGV = ["--arch", "flux-dev", "--shape", FLUX_SHAPE, "--steps",
                      str(SERVE_STEPS), "--requests", "2", "--stream-every", "4",
                      *FLUX_LAUNCHER_CUT]


def flux_kernel_phase(flush):
    """reuse[flux]: fused_reuse bit for bit against its plain version at
    flux's served call, (4, 24, 4608, 128) bf16 on grid (1, 64, 64) behind
    512 text tokens, axes x/y, θ 0.2, on a contiguous operand and on the
    (B, N, H, d) storage that ``models.mmdit.joint_attention`` hands over
    transposed (the text rows must come back untouched); then the ripple
    kernel on the operands that snap produces against
    :func:`attention_oracle` at the bf16 bar, on the tensor cores.  Times
    both there: fused_reuse by device time with the L2 flushed, ripple
    against its plain version (a loop over the batch rows), SDPA and its
    bound.  Returns (fused_reuse's times, ripple's instance)."""
    import torch
    from repro_torch.kernels.reuse_mask import ops as reuse_ops
    from repro_torch.kernels.ripple import ops as ripple_ops
    from repro_torch.kernels.ripple.ref import ripple_attention_ref

    bf16 = torch.bfloat16
    res = []
    for view in ("contiguous", "transposed"):
        check_reuse(res, FLUX_SNAP, FLUX_GRID, bf16, "channel", (0.2,) * 3,
                    axes=("x", "y"), view=view, text=FLUX_TEXT)
    gs = (FLUX_TEXT[0], FLUX_SNAP[2])
    qkv = (*FLUX_SNAP[:2], FLUX_TEXT[0] + FLUX_SNAP[2], FLUX_SNAP[3])
    th = dict(zip("txy", (0.2,) * 3))
    q, k = (reuse_ops.fused_compute_reuse(
        reuse_operand(FLUX_SNAP, bf16, seed, 0.6, "transposed", FLUX_TEXT), FLUX_GRID,
        th, axes=("x", "y"), grid_slice=gs)[0] for seed in (41, 42))
    v = correlated(qkv, bf16, 43)
    err = check_ripple(res, q, k, v, f"{qkv} flux-dev main-path snapped operands")
    log(f"reuse[flux]: {sum(res)}/{len(res)} checks ok")

    x = reuse_operand(FLUX_SNAP, bf16, 44, 0.6, "transposed", FLUX_TEXT)
    t_reuse = time_fused_reuse(x, FLUX_GRID, ("x", "y"), gs,
                               "flux-dev served call, the transposed storage", flush)
    del x
    scale = ripple_ops.attention_scale(qkv[-1])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_time_ms(lambda: ripple_ops.ripple_attention(q, k, v), iters=10)
    plain = cuda_time_ms(lambda: [ripple_attention_ref(
        q[b:b + 1], k[b:b + 1], v[b:b + 1], scale) for b in range(q.shape[0])],
        iters=2, warmup=1)
    lib = cuda_time_ms(lambda: sdpa(q, k, v, scale=scale), iters=10)
    bound, by, flops, _, nbytes = ripple_bound(q, k, qkv[-1])
    qf, kf, _ = ripple_ops.ripple_tile_stats(q, k, qkv[-1])
    log(f"time ripple_attention bf16 {qkv} (flux-dev, tensor cores "
        f"{ripple_ops.uses_tensor_cores(q, v)}; tiles collapsed q {qf:.3f} k {kf:.3f}): "
        f"kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms (a loop "
        f"over the batch rows), sdpa {lib:.4f} ms, bound {bound:.4f} ms ({by}: "
        f"{flops / 1e12:.4f} TFLOP, {nbytes / 1e6:.1f} MB); kernel/sdpa {ms / lib:.3f}, "
        f"bound/kernel {bound / ms:.3f}; {CARD}")
    del q, k, v
    torch.cuda.empty_cache()
    return t_reuse, {"shape": list(qkv), "ms": ms, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": "bytes" if by == "bytes" else "operations",
                     "bound_detail": by, "library_ms": lib, "max_abs_err": err}


def serve_flux():
    """flux-dev at full width and depth (19 double and 38 single blocks,
    d_model 3072, 24 heads of 128, MLP 12288, text 512 x 4096, RoPE
    16/56/56) on gen_1024: latents 128 x 128 x 16, 4096 image + 512 text
    tokens, 4 requests in one batch through the ripple policy, Euler
    rectified flow cut to 12 steps (step 10 snaps at θ 0.2), with the
    sentinels and the degradation ladder on.  fused_reuse must launch
    twice and ripple once a block-step, ripple on the tensor cores, the
    sparse and adaLN kernels never, no plain version on the card, and the
    ladder's and engine's quiet counters must stay 0.  Then the same batch
    with ripple off (dense attention, no kernel of the port), and one
    forward at step 10 profiled.  Returns the launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serving_shape
    from repro_torch.models.params import init_mmdit

    arch = get_config("flux-dev")
    shape = serving_shape(arch, FLUX_SHAPE, smoke=False, steps=SERVE_STEPS)
    m = arch.model
    hw = shape.img_res // 8 // m.patch
    blocks = m.n_double_blocks + m.n_single_blocks
    log(f"serve: flux-dev full width and depth {m.n_double_blocks} double + "
        f"{m.n_single_blocks} single blocks, d_model={m.d_model} heads={m.num_heads}x"
        f"{m.d_model // m.num_heads} mlp={int(m.d_model * m.mlp_ratio)} text="
        f"{m.txt_tokens}x{m.txt_dim} axes={m.axes_dim}; {shape.name}: latents "
        f"{shape.img_res // 8}x{shape.img_res // 8}x{m.in_channels}, grid (1, {hw}, {hw}) "
        f"= {hw * hw} image + {m.txt_tokens} text = {hw * hw + m.txt_tokens} tokens, "
        f"{FLUX_REQUESTS} requests; cut: Euler steps 50->{SERVE_STEPS}")
    t0 = time.perf_counter()
    model = init_mmdit(m, seed=0, device="cuda", dtype=torch.bfloat16, zero_init=False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: {n_params / 1e9:.3f} B params, "
        f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB "
        f"(bf16, every leaf drawn from a seeded generator, the zero-initialised mod, "
        f"final_mod, final and bias leaves too) in {time.perf_counter() - t0:.1f}s")
    metrics = {}
    counts, lat_shape, paths = serve_ripple(
        arch, shape, model, "flux-dev", requests=FLUX_REQUESTS,
        absent=("sparse_attention", "adaln"), plain_absent=vdit_plain_versions(),
        guardrail=True, metrics=metrics)
    want = {"fused_reuse": 2 * blocks * shape.steps, "ripple_attention": blocks * shape.steps}
    log(f"serve[flux-dev]: launches {counts} (expected {want} at every block-step); "
        f"engine and ladder counters {metrics}")
    checks = {
        "fused_reuse twice and ripple once a block-step":
            all(counts[n] == c for n, c in want.items()),
        "every ripple call on the tensor cores at (4608, 128)":
            bool(paths) and all(tc and (n, d) == (4608, 128) for _, n, d, _, tc in paths),
        "no degradation, retry, quarantine or watchdog trip":
            quiet_counters({"counters": metrics}),
    }
    report("flux-dev", checks)
    off = dataclasses.replace(arch, ripple=dataclasses.replace(arch.ripple, enabled=False))
    serve_phase("flux-dev ripple off", off, dataclasses.replace(shape, steps=FLUX_OFF_STEPS),
                model, requests=FLUX_REQUESTS,
                absent=("fused_reuse", "ripple_attention", "sparse_attention", "adaln"))
    profile_forward("flux-dev", arch, model, lat_shape,
                    {"ripple_attention": "ripple", "fused_reuse": "fused_reuse"},
                    annotate=ripple_ranges(), batch=FLUX_REQUESTS, total=shape.steps)
    del model
    torch.cuda.empty_cache()
    return counts


def serve_flux_launcher():
    """``repro_torch.launch.serve.main`` on flux-dev at full width (depth cut
    to 2 double + 4 single blocks to keep the phase short; the launcher's
    init zeroes the mod, final and bias leaves as the JAX defs do): 2
    requests at gen_1024, 12 Euler steps, streamed every 4; both must
    complete with finite latents, 3 chunks each (the last equal to the
    result), fused_reuse twice and ripple once a block-step, no plain
    version on the card and the quiet counters 0.  Returns the launch
    counts."""
    import json
    import math
    import tempfile

    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as serve_lib
    from repro_torch.serving import engine as engine_lib

    streams = {}

    log(f"serve[flux-launcher]: python -m repro_torch.launch.serve "
        f"{' '.join(FLUX_LAUNCHER_ARGV)}; flux-dev full width; cut: depth 19 + 38 -> 2 + 4 "
        f"blocks (to keep the phase short), Euler steps 50->{SERVE_STEPS}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "summary.json")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with wrapped(engine_lib.DiffusionEngine, "stream", recording(streams)), \
                plain_guard(vdit_plain_versions()) as plain:
            done = serve_lib.main(FLUX_LAUNCHER_ARGV + ["--summary-json", path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with open(path, encoding="utf-8") as f:
            summary = json.load(f)
    chunk_ok = True
    for r in done:
        chunks = streams.get(r.request_id, [])
        same = bool(chunks) and np.array_equal(chunks[-1], r.latents)
        chunk_ok &= len(chunks) == math.ceil(SERVE_STEPS / 4) and same
        log(f"serve[flux-launcher]: request {r.request_id} latents {r.latents.shape} "
            f"latency {r.latency_s:.3f}s, ttff {r.ttff_s:.3f}s, {len(chunks)} chunks, "
            f"last chunk equals the result: {same}; batch {r.batch_index} served in "
            f"{r.walltime_s:.3f}s; {CARD}")
    log(f"serve[flux-launcher]: summary {summary}; launches {counts}; plain versions "
        f"called on the card {plain}; {wall:.1f}s with the model's init; {CARD}")
    block_steps = 6 * SERVE_STEPS * len({r.batch_index for r in done})
    report("flux-launcher", {
        "both requests completed": summary["completed"] == [0, 1]
        and not summary["errors"],
        "3 chunks a request, the last equal to the result": chunk_ok,
        "finite latents of (128, 128, 16)": all(
            r.latents.shape == (128, 128, 16) and np.isfinite(r.latents).all()
            for r in done),
        "fused_reuse twice and ripple once a block-step":
            counts["fused_reuse"] == 2 * block_steps
            and counts["ripple_attention"] == block_steps,
        "no degradation, retry, quarantine or watchdog trip": quiet_counters(summary),
        "no plain version ran on the card": not any(plain.values()),
    })
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# The vision family: vit-l16 and efficientnet-b7 (slice 16)
# ---------------------------------------------------------------------------


VIT_GRID = (1, 14, 14)          # 224² at patch 16
VIT_SNAP = (128, 16, 196, 64)   # the ViT's Q/K grid tokens at serve_b128
VIT_TEXT = (1, 0)               # the cls token before them: 197 tokens
# The fixed threshold of DESIGN.md §6 from step 0, under which entries
# snap (the config's ramp alone gives θ 0 at the ViT's step 0 of 2).
VIT_RIPPLE = ("ripple.enabled=true", "ripple.i_min=0", "ripple.fixed_threshold=0.2")
CLASSIFY_SHAPES = ("serve_b1", "serve_b128")


def vit_kernel_phase(flush):
    """reuse[vit]: fused_reuse bit for bit against its plain version at
    vit-l16's served call, (128, 16, 197, 64) with the cls token before a
    (1, 14, 14) grid (slice (1, 196): an odd token count and start),
    axes x/y, θ 0.2, bf16 and f32 on the contiguous operand
    ``mha_attention`` hands over and bf16 on a transposed one; then its
    device time there against the bytes bound.  Returns the times."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    res = []
    for dt, view in ((bf16, "contiguous"), (f32, "contiguous"), (bf16, "transposed")):
        check_reuse(res, VIT_SNAP, VIT_GRID, dt, "channel", (0.2,) * 3, axes=("x", "y"),
                    view=view, text=VIT_TEXT)
    log(f"reuse[vit]: {sum(res)}/{len(res)} checks bit-equal")
    x = reuse_operand(VIT_SNAP, bf16, 46, 0.6, text=VIT_TEXT)
    out = time_fused_reuse(x, VIT_GRID, ("x", "y"), (VIT_TEXT[0], VIT_SNAP[2]),
                           "vit-l16 served call, serve_b128", flush)
    return {"shape": [VIT_SNAP[0], VIT_SNAP[1], VIT_TEXT[0] + VIT_SNAP[2], VIT_SNAP[3]],
            **out}


def vision_model(name):
    """(arch, model) of a vision arch at full width and depth, every leaf
    drawn from a seeded generator (bf16 on the card)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_model

    arch = get_config(name)
    t0 = time.perf_counter()
    model = init_model(arch.model, seed=0, device="cuda", dtype=torch.bfloat16,
                       zero_init=False)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"classify: {name} {arch.model}; {n / 1e6:.3f} M params (bf16, every leaf drawn "
        f"from a seeded generator, the zero-initialised bias and norm leaves too) in "
        f"{time.perf_counter() - t0:.1f}s; no cut: full width and depth")
    return arch, model


def vision_images(shape, seed=0):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.randn((shape.batch, shape.img_res, shape.img_res, 3), generator=g,
                       device="cuda")


def classify_cell(label, shape, call, base, *, launched=None, spy=None, iters=10):
    """One classify cell: ``call`` once with the launch counters set to 0
    just before and read just after (the path's run; ``launched`` the
    exact count of each kernel, None: none may launch), with the plain
    versions watched; then its time a batch by CUDA events after
    warm-up, images/s and the peak device memory of the timed calls,
    also less ``base``, the bytes earlier phases left allocated.
    Returns (logits of the counted run, launch counts, ms a batch)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_guard(vdit_plain_versions()) as plain, \
            (spy() if spy is not None else contextlib.nullcontext()):
        logits = call()
        torch.cuda.synchronize()
    counts = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(call, iters=iters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {n: (launched or {}).get(n, 0) for n in counts}
    log(f"classify[{label}]: {shape.name} batch {shape.batch} at {shape.img_res}²: "
        f"{ms:.3f} ms a batch (CUDA events, {iters} batches after warm-up), "
        f"{shape.batch / ms * 1e3:.1f} images/s, peak device memory {peak:.2f} GiB "
        f"({peak - base / 2**30:.2f} GiB above what earlier phases left); launches "
        f"{counts}; {CARD}")
    report(label, {
        f"finite logits of ({shape.batch}, 1000)":
            tuple(logits.shape) == (shape.batch, 1000)
            and bool(torch.isfinite(logits.float()).all()),
        f"launches {dict((n, c) for n, c in want.items() if c) or 'none'} exactly":
            counts == want,
        "no plain version ran on the card": not any(plain.values()),
    }, kind="classify")
    return logits, counts, ms


def classify_vit():
    """classify[vit-l16] at serve_b1 and serve_b128 through the classify
    workload (ripple off: plain attention, no kernel of the port), then
    classify[vit-l16 ripple]: ``vit_apply`` under the fixed threshold at
    both batches (fused_reuse twice a layer, 48 a forward; N = 197 is
    odd, so ``auto`` leaves the ripple kernel out: 0 launches), with the
    snap fraction of Q and K and the logits' relative L2 against ripple
    off; then profiles one serve_b128 forward of each.  Returns the
    launch counts of a serve_b128 forward under ripple."""
    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.core import dispatch as dispatch_lib
    from repro_torch.core import policy as policy_lib
    from repro_torch.launch.workloads import classify_step
    from repro_torch.models import common as common_lib
    from repro_torch.models import vit as vit_lib

    # The forward's own families: its LayerNorms (f32), MLPs (GEMMs and
    # tanh GELU) and plain attention (two GEMMs and an f32 softmax); the
    # Q/K/V/O projections stay in gemm.
    ranges = [(vit_lib, "layernorm", "layernorm"), (common_lib.MLP, "forward", "mlp"),
              (dispatch_lib, "dense_attention", "attention")]
    base = torch.cuda.memory_allocated()
    arch, model = vision_model("vit-l16")
    rip = apply_overrides(arch, VIT_RIPPLE).ripple
    layers = arch.model.num_layers
    for name in CLASSIFY_SHAPES:
        shape = arch.shape(name)
        images = vision_images(shape)
        step = classify_step(arch, shape, model)

        def off_call():
            return step(images)

        def ripple_call():
            return vit_lib.vit_apply(model, images, arch.model, ripple=rip)

        off, _, off_ms = classify_cell("vit-l16", shape, off_call, base)
        snapped = {"q": [], "k": []}

        def spy():
            def make(orig):
                def decide(self, q, k, **kw):
                    d = orig(self, q, k, **kw)
                    snapped["q"].append(d.q_mask.float().mean())
                    snapped["k"].append(d.k_mask.float().mean())
                    return d
                return decide
            return wrapped(policy_lib.RipplePolicy, "decide", make)

        on, counts, on_ms = classify_cell("vit-l16 ripple", shape, ripple_call, base,
                                          launched={"fused_reuse": 2 * layers}, spy=spy)
        frac = {a: torch.stack(v).mean().item() for a, v in snapped.items()}
        rel = ((on.float() - off.float()).norm() / off.float().norm()).item()
        log(f"classify[vit-l16 ripple]: {name}: {' '.join(VIT_RIPPLE)}; snapped Q "
            f"{frac['q']:.4f} K {frac['k']:.4f} over the {layers} layers; logits' "
            f"relative L2 against ripple off {rel:.4e}; {on_ms:.3f} ms against "
            f"{off_ms:.3f} ms off")
        report("vit-l16 ripple", {"entries snapped": frac["q"] > 0 and frac["k"] > 0,
                                  "the logits moved": rel > 0}, kind="classify")
        if name == "serve_b128":
            desc = f"{name} batch {shape.batch}, {layers} layers, 197 tokens"
            profile_call("vit-l16", off_call, {}, annotate=ranges, desc=desc)
            profile_call("vit-l16 ripple", ripple_call, {},
                         annotate=ranges + ripple_ranges()[1:], desc=desc)
        del images
    del model
    torch.cuda.empty_cache()
    return counts


def classify_effnet():
    """classify[efficientnet-b7] at serve_b1 and serve_b128 through the
    classify workload (cuDNN convolutions, batch statistics; no kernel of
    the port), then one serve_b128 forward profiled."""
    import torch
    from repro_torch.launch.workloads import classify_step
    from repro_torch.models import efficientnet as eff_lib

    base = torch.cuda.memory_allocated()
    arch, model = vision_model("efficientnet-b7")
    for name in CLASSIFY_SHAPES:
        shape = arch.shape(name)
        images = vision_images(shape)
        fn = classify_step(arch, shape, model)
        classify_cell("efficientnet-b7", shape, lambda: fn(images), base)
        if name == "serve_b128":
            profile_call(
                "efficientnet-b7", lambda: fn(images), {},
                annotate=[(eff_lib, "conv2d", "conv"), (eff_lib, "batchnorm", "batchnorm")],
                desc=f"{name} batch {shape.batch}, 55 MBConv blocks")
        del images
    del model
    torch.cuda.empty_cache()


def vision_reference_check(label, name, overrides=()):
    """The smoke config's forward in f32, batch 2, through the kernels on
    the card against the same forward through the plain versions on the
    CPU, same params and images; with ripple on, fused_reuse must launch
    twice a layer on the card."""
    import numpy as np
    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.efficientnet import effnet_apply
    from repro_torch.models.params import init_model
    from repro_torch.models.vit import vit_apply

    arch = apply_overrides(get_smoke_config(name), overrides)
    m = arch.model
    images = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, m.img_res, m.img_res, 3)).astype(np.float32))
    fwd = (functools.partial(vit_apply, ripple=arch.ripple) if arch.family == "vit"
           else effnet_apply)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = init_model(m, seed=1, device="cpu", zero_init=False).to(dev)
        reset_launch_counts()
        outs[dev] = fwd(model, images.to(dev), m, compute_dtype=torch.float32).float().cpu()
        if dev == "cuda":
            launched = launch_counts()["fused_reuse"]
    want = 2 * m.num_layers if arch.ripple.enabled else 0
    diff = ((outs["cuda"] - outs["cpu"]).norm() / outs["cpu"].norm()).item()
    ok = bool(torch.isfinite(outs["cuda"]).all()) and diff < 1e-3 and launched == want
    log(f"reference[{label}]: {arch.name} forward, f32, batch 2 at {m.img_res}², card "
        f"kernels vs CPU plain versions: relative L2 {diff:.3e} (tol 1e-3); fused_reuse "
        f"launches on the card {launched} (expected {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("card forward disagrees with the CPU reference")


# ---------------------------------------------------------------------------
# 8h. the LM family (slice 17): prefill and decode through the port's
# workloads and LMEngine; no kernel of the port lies on this path
# ---------------------------------------------------------------------------

LM_PREFILL_BATCH = 2   # prefill_32k's 32 sequences cut to 2: 4.56 GB of cache each
LM_DECODE = (8, 1024, 32)   # decode_32k's 128 sequences cut to 8: prompt, new tokens
LM_MOE = (2, 4096, 16)      # qwen2-moe-a2.7b: batch, prompt, new tokens
# Full width at cut depth: full-depth bf16 weights are 65.5 GB and 84 GB.
LM_CUT = (("qwen3-32b", 16), ("phi3.5-moe-42b-a6.6b", 8))
LM_CUT_RUN = (1, 1024, 8)
# tests/test_torch_lm.py's bars: BF16_REL (relative L2 of bf16 logits,
# two implementations) and F32_REL (max abs error over the reference's
# max abs, float32).
LM_BF16_REL = 3e-2
LM_F32_REL = 1e-5
LM_SMOKE = ("gemma3-4b", "qwen3-32b", "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")


def lm_model(name, layers=None):
    """(arch, model) of an LM at full width (depth cut to ``layers``),
    bf16 weights from the seeded init on the card."""
    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_model

    arch = get_config(name)
    if layers is not None:
        arch = apply_overrides(arch, (f"model.num_layers={layers}",))
    t0 = time.perf_counter()
    model = init_model(arch.model, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    cut = (f"depth cut from {get_config(name).model.num_layers} to {layers}"
           if layers is not None else "full width and depth")
    log(f"lm: {name} {arch.model}; {n / 1e9:.3f} B params, {2 * n / 1e9:.2f} GB in bf16 "
        f"(seeded init) in {time.perf_counter() - t0:.1f}s; {cut}")
    return arch, model


def lm_tokens(batch, length, vocab, seed):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.randint(0, vocab, (batch, length), generator=g, device="cuda")


@contextlib.contextmanager
def no_kernel_launches(label):
    """Every launch counter set to 0 before the block and still 0 after:
    no kernel of the port lies on the LM path."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    yield
    torch.cuda.synchronize()
    counts = launch_counts()
    report(label, {f"no kernel of the port launched ({counts})":
                   not any(counts.values())}, kind="lm")


def timed(fn):
    """(result, seconds) of one call, the card synchronised around it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lm_prefill_phase():
    """lm[gemma3-4b prefill_32k]: ``lm_prefill`` through the prefill
    workload on LM_PREFILL_BATCH prompts of the shape's 32768 tokens,
    then a profile of one prompt's prefill by kernel family.  Returns
    (arch, model) for the decode phase."""
    import torch
    from repro_torch.launch.workloads import lm_serve_steps

    label = "gemma3-4b prefill_32k"
    arch, model = lm_model("gemma3-4b")
    m, shape = arch.model, arch.shape("prefill_32k")
    prefill, _ = lm_serve_steps(arch, shape, model)
    B, S = LM_PREFILL_BATCH, shape.seq_len
    tokens = lm_tokens(B, S, m.vocab_size, 70)
    timed(lambda: prefill(tokens[:1, :1024]))  # warm-up: cuBLAS, the allocator
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with no_kernel_launches(label):
        (logits, cache), sec = timed(lambda: prefill(tokens))
    peak = torch.cuda.max_memory_allocated() / 2**30
    kv_gb = sum(c.numel() * c.element_size() for c in cache) / 1e9
    want = (m.num_layers, B, S, m.num_kv_heads, m.resolved_head_dim)
    log(f"lm[{label}]: lm_prefill of {B} x {S} tokens (batch cut from "
        f"{shape.global_batch}): {sec:.3f} s, {B * S / sec:.1f} tokens/s, peak device "
        f"memory {peak:.2f} GiB ({peak - base / 2**30:.2f} GiB above the weights), KV "
        f"cache {kv_gb:.2f} GB in bf16; {CARD}")
    report(label, {
        f"finite last logits of ({B}, 1, {m.vocab_size})":
            tuple(logits.shape) == (B, 1, m.vocab_size)
            and bool(torch.isfinite(logits.float()).all()),
        f"a K and a V cache of {want}, the last position written":
            all(tuple(c.shape) == want for c in cache)
            and all(bool(c[:, :, -1].abs().sum(-1).gt(0).all()) for c in cache),
    }, kind="lm")
    del logits, cache
    torch.cuda.empty_cache()
    profile_call(label, lambda: prefill(tokens[:1]),
                 {"elementwise": "elementwise", "reduce": "reduce_kernel",
                  "softmax": "softmax"},
                 desc=f"lm_prefill of 1 x {S} tokens, {m.num_layers} layers")
    torch.cuda.empty_cache()
    return arch, model


def lm_decode_phase(arch, model):
    """lm[gemma3-4b decode_32k]: ``LMEngine.generate`` greedy on the
    decode workload (cache of the shape's 32768 positions), its prefill
    timed apart, ms a decoded token; then the first two decoded
    positions' logits against ``lm_apply`` over prompt + token (two of
    the prompts), within LM_BF16_REL."""
    import torch
    from repro_torch.launch.workloads import lm_serve_steps
    from repro_torch.models.transformer_lm import lm_apply
    from repro_torch.serving.engine import LMEngine

    label = "gemma3-4b decode_32k"
    m, shape = arch.model, arch.shape("decode_32k")
    B, P, new = LM_DECODE
    prefill, decode = lm_serve_steps(arch, shape, model)
    rec = {"logits": [], "prefill_s": 0.0}

    def prefill_rec(t):
        (logits, cache), sec = timed(lambda: prefill(t))
        rec["prefill_s"] = sec
        rec["logits"].append(logits[:, -1].float())
        return logits, cache

    def decode_rec(t, c, i):
        logits, c = decode(t, c, i)
        if len(rec["logits"]) < 2:
            rec["logits"].append(logits[:, -1].float())
        rec["cache"] = c
        return logits, c

    eng = LMEngine(prefill_rec, decode_rec, max_len=shape.seq_len)
    tokens = lm_tokens(B, P, m.vocab_size, 71)
    eng.generate(tokens[:1, :64], 2)  # warm-up
    rec["logits"].clear()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with no_kernel_launches(label):
        out, sec = timed(lambda: eng.generate(tokens, new))
    peak = torch.cuda.max_memory_allocated() / 2**30
    dec = sec - rec["prefill_s"]
    ms_tok = dec / (new - 1) * 1e3  # the first token comes from the prefill
    kv_gb = 2 * m.num_layers * B * shape.seq_len * m.num_kv_heads * \
        m.resolved_head_dim * 2 / 1e9
    log(f"lm[{label}]: LMEngine.generate greedy, {B} prompts of {P} tokens (batch cut "
        f"from {shape.global_batch}), max_len {shape.seq_len}, {new} new tokens: "
        f"{sec:.3f} s; prefill {rec['prefill_s']:.3f} s ({B * P / rec['prefill_s']:.1f} "
        f"tokens/s); decode {ms_tok:.3f} ms a token step ({(new - 1) * B / dec:.1f} "
        f"tokens/s over the batch); peak device memory {peak:.2f} GiB ({peak - base / 2**30:.2f} "
        f"GiB above the weights; KV cache {kv_gb:.2f} GB); {CARD}")
    # One more decode step, at the next free position: the host
    # synchronisations in it (CUDA's sync debug mode), then by kernel family.
    import warnings

    from repro_torch.models import attention as attn_lib

    last = out[:, -1:]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            decode(last, rec["cache"], P + new - 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0][:80] for w in caught
             if "synchroniz" in str(w.message)]
    log(f"lm[{label}]: host synchronisations in one decode step: {len(syncs)} "
        f"{sorted(set(syncs))}")
    profile_call(f"{label} step", lambda: decode(last, rec["cache"], P + new - 1),
                 {"elementwise": "elementwise", "reduce": "reduce_kernel",
                  "softmax": "softmax"},
                 annotate=[(attn_lib, "_gqa_core_dense", "attention_core")],
                 desc=f"one decode step, batch {B}, a cache of {shape.seq_len} positions")
    del rec["cache"]
    torch.cuda.empty_cache()
    first = [r[:2] for r in rec["logits"]]
    seq = torch.cat([tokens[:2], out[:2, :1]], dim=1)
    full, _, _ = lm_apply(model, seq, m, logits_mode="all")
    errs = [((a - full[:, P - 1 + j].float()).norm()
             / full[:, P - 1 + j].float().norm()).item() for j, a in enumerate(first)]
    log(f"lm[{label}]: decoded positions {P - 1} and {P} against lm_apply over prompt + "
        f"token (2 prompts): relative L2 {errs[0]:.3e}, {errs[1]:.3e} (bar {LM_BF16_REL})")
    del full
    report(label, {
        f"({B}, {new}) token ids in the vocabulary": tuple(out.shape) == (B, new)
        and bool(((out >= 0) & (out < m.vocab_size)).all()),
        "first two decoded positions' logits within the bf16 bar":
            len(errs) == 2 and max(errs) < LM_BF16_REL,
    }, kind="lm")
    torch.cuda.empty_cache()
    return {"prefill_s": rec["prefill_s"], "ms_per_token": ms_tok, "peak_gib": peak}


def lm_generate_phase(label, arch, model, batch, prompt, new, aux_of=None):
    """``LMEngine.generate`` greedy on the decode_32k workload (cache of
    32768 positions): its prefill timed apart, ms a decoded token, peak
    memory; ``aux_of`` (the MoE module) sums the router aux of the
    prefill's layers."""
    import torch
    from repro_torch.launch.workloads import lm_serve_steps
    from repro_torch.serving.engine import LMEngine

    m, shape = arch.model, arch.shape("decode_32k")
    prefill, decode = lm_serve_steps(arch, shape, model)
    rec = {"prefill_s": 0.0, "aux": []}

    def prefill_rec(t):
        (out, sec) = timed(lambda: prefill(t))
        rec["prefill_s"] = sec
        return out

    eng = LMEngine(prefill_rec, decode, max_len=shape.seq_len)
    tokens = lm_tokens(batch, prompt, m.vocab_size, 72)
    eng.generate(tokens[:1, :64], 2)  # warm-up
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def aux_rec(orig):
        def f(*a, **kw):
            out, aux = orig(*a, **kw)
            if a[1].shape[1] > 1:  # the prefill's calls
                rec["aux"].append(aux)
            return out, aux
        return f

    with (wrapped(aux_of, "moe_ffn", aux_rec) if aux_of is not None
          else contextlib.nullcontext()), no_kernel_launches(label):
        out, sec = timed(lambda: eng.generate(tokens, new))
    peak = torch.cuda.max_memory_allocated() / 2**30
    dec = sec - rec["prefill_s"]
    ms_tok = dec / (new - 1) * 1e3
    aux = float(sum(a.float() for a in rec["aux"])) if rec["aux"] else None
    log(f"lm[{label}]: LMEngine.generate greedy, {batch} x {prompt} prompt tokens, max_len "
        f"{shape.seq_len}, {new} new tokens: {sec:.3f} s; prefill {rec['prefill_s']:.3f} s "
        f"({batch * prompt / rec['prefill_s']:.1f} tokens/s); decode {ms_tok:.3f} ms a token "
        f"step; peak device memory {peak:.2f} GiB ({peak - base / 2**30:.2f} GiB above the "
        f"weights)" + (f"; router aux of the prefill (sum over {len(rec['aux'])} layers) "
                       f"{aux:.6f}" if aux is not None else "") + f"; {CARD}")
    checks = {f"({batch}, {new}) token ids in the vocabulary":
              tuple(out.shape) == (batch, new)
              and bool(((out >= 0) & (out < m.vocab_size)).all())}
    if aux_of is not None:
        checks[f"a finite positive router aux from each of {m.num_layers} layers"] = \
            len(rec["aux"]) == m.num_layers and aux is not None and 0 < aux < float("inf")
    report(label, checks, kind="lm")
    torch.cuda.empty_cache()
    return {"prefill_s": rec["prefill_s"], "ms_per_token": ms_tok, "peak_gib": peak,
            "aux": aux}


# lm[qwen2-moe-a2.7b ep] (slice 20): expert parallelism on a 1x4 dispatch
# mesh (4 model shards of the one card) on the model 8h built.
EP_MESH = "1x4"
EP_RUN = (2, 1024, 4)     # prompts, prompt tokens, decoded positions
EP_CACHE = 2048           # KV positions (decode_32k's 32768 cut: 0.4 GB)
EP_NO_DROP = 64.0         # capacity factor: C = N·k a shard, nothing drops
# EP against the dense path at full depth, nothing dropped, in float32 on
# one prompt (the model converted in place after its bf16 uses: 60.6 GB).
# In bf16 EP and the dense path round differently and the difference
# grows with depth (measured on an H100: hidden states equal after 1
# layer, 2.9e-6 apart after 2, 1.4e-2 after 4, 4.6e-2 after 24); the
# reference's own EP drifts from its dense path as far (4.6e-2 at 4
# layers of the smoke config, tests/test_torch_moe_ep.py), so the bf16
# distance is reported, not held.
EP_F32_BAR = 1e-4
EP_CPU = (2, 256)         # card vs 4 CPU shards: layers, tokens (f32)


def with_moe(arch, model, capacity):
    """(arch, model) with the MoE's capacity factor replaced: a view of
    ``model`` sharing its weights."""
    import copy

    cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(
        model.cfg.moe, capacity_factor=capacity))
    view = copy.copy(model)
    view.cfg = cfg
    return dataclasses.replace(arch, model=cfg), view


def ep_slot_recorder():
    """A ``wrapped`` maker for ``moe.dispatch_slots`` recording each
    shard's kept-slot mask by (first expert, call number), and the kept
    and routed slot counts."""
    import threading

    rec = {"keep": {}, "kept": 0, "routed": 0}
    lock = threading.Lock()

    def make(orig):
        def f(topk_idx, e_lo, E_loc, C):
            keep, dest_e, dest_c = orig(topk_idx, e_lo, E_loc, C)
            mine = ((topk_idx >= e_lo) & (topk_idx < e_lo + E_loc)).sum()
            kept = keep.cpu()
            with lock:
                n = sum(1 for (e, _) in rec["keep"] if e == e_lo)
                rec["keep"][(e_lo, n)] = kept
                rec["kept"] += int(kept.sum())
                rec["routed"] += int(mine)
            return keep, dest_e, dest_c
        return f

    return rec, make


def lm_ep_phase(arch, model):
    """``lm[qwen2-moe-a2.7b ep]``: ``lm_serve_steps(mesh=1x4)`` on the full
    qwen2-moe-a2.7b that ``lm[qwen2-moe-a2.7b]`` built, every MoE layer
    through ``moe_ffn(impl="auto")`` -> expert parallelism over the 4
    model shards (16 of the 64 experts each).  In bf16: at the config's
    capacity 1.25 the dropped slots and the prefill time, and with the
    capacity raised so nothing drops the distance of the prefill's and
    EP_RUN decoded positions' logits (the dense run's tokens fed to both)
    to the dense path.  The first EP_CPU layers in float32, on the card
    and on 4 CPU shards: every shard's kept-slot mask bit-equal.  Then
    the model in float32 (converted in place; the caller frees it): EP
    without drops within EP_F32_BAR of the dense path at full depth.  No
    kernel of the port launches."""
    import copy

    import torch
    from repro_torch.distributed.sharding import ShardCtx, decode_act_rules
    from repro_torch.launch.mesh import parse_mesh_spec
    from repro_torch.launch.workloads import lm_serve_steps
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer_lm import lm_apply

    B, S, new = EP_RUN
    with forced_devices(4):
        mesh = parse_mesh_spec(EP_MESH, device="cuda")
    shape = dataclasses.replace(arch.shape("decode_32k"), seq_len=EP_CACHE)
    m = arch.model
    tokens = lm_tokens(B, S, m.vocab_size, 74)
    label = "qwen2-moe-a2.7b ep"

    def run(capacity, use_mesh, feed=None, dtype=torch.bfloat16, toks=tokens):
        a, view = with_moe(arch, model, capacity)
        prefill, decode = lm_serve_steps(a, shape, view, mesh=mesh if use_mesh else None)
        if dtype != torch.bfloat16:  # the serving steps run bf16; f32 compute here
            def prefill(t, a=a, view=view):
                from repro_torch.models.transformer_lm import lm_prefill
                return lm_prefill(view, t, a.model, EP_CACHE, compute_dtype=dtype,
                                  ctx=ShardCtx(mesh, decode_act_rules(mesh))
                                  if use_mesh else ShardCtx())

            def decode(t, c, i, a=a, view=view):
                from repro_torch.models.transformer_lm import lm_decode_step
                return lm_decode_step(view, t, c, i, a.model, compute_dtype=dtype,
                                      ctx=ShardCtx(mesh, decode_act_rules(mesh))
                                      if use_mesh else ShardCtx())
        (logits, cache), sec = timed(lambda: prefill(toks))
        steps, fed = [logits], []
        for i in range(new - 1):
            tok = logits.argmax(-1) if feed is None else feed[i]
            fed.append(tok)
            logits, cache = decode(tok, cache, toks.shape[1] + i)
            steps.append(logits)
        del cache
        return torch.cat(steps, 1).float(), sec, fed

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    with no_kernel_launches(label):
        dense, dense_s, fed = run(EP_NO_DROP, False)
        rec, make = ep_slot_recorder()
        with wrapped(moe_lib, "dispatch_slots", make):
            ep, ep_s, _ = run(EP_NO_DROP, True, fed)
        bf16_rel = rel(ep, dense)
        del ep, dense
        rec2, make2 = ep_slot_recorder()
        a, view = with_moe(arch, model, m.moe.capacity_factor)
        prefill, _ = lm_serve_steps(a, shape, view, mesh=mesh)
        with wrapped(moe_lib, "dispatch_slots", make2):
            (_, c), drop_s = timed(lambda: prefill(tokens))
        del c, view
    torch.cuda.empty_cache()
    dropped = rec2["routed"] - rec2["kept"]
    log(f"lm[{label}]: bf16, {B} x {S} prompt tokens + {new - 1} decoded positions, mesh "
        f"{mesh.shape} (4 shards of the one card, 16 experts each): capacity "
        f"{EP_NO_DROP:g} kept {rec['kept']} of {rec['routed']} routed slots, logits "
        f"relative L2 {bf16_rel:.3e} against the dense path (reported, not held: bf16 rounding); "
        f"prefill {ep_s:.3f} s EP, {dense_s:.3f} s dense; at the config's capacity "
        f"{m.moe.capacity_factor:g}: {dropped} of {rec2['routed']} slots dropped "
        f"({dropped / max(rec2['routed'], 1):.4%}), prefill {drop_s:.3f} s; {CARD}")
    # The first layers in float32, card against 4 CPU shards.
    layers, n_tok = EP_CPU
    cut = copy.copy(model)
    cut._modules = dict(model._modules)
    cut.blocks = torch.nn.ModuleList(list(model.blocks)[:layers])
    cut.cfg = dataclasses.replace(model.cfg, num_layers=layers)
    card32 = copy.deepcopy(cut).float()
    cpu32 = copy.deepcopy(card32).cpu()
    del cut
    toks = tokens[:1, :n_tok]
    with forced_devices(4):
        cpu_mesh = parse_mesh_spec(EP_MESH, device="cpu")
    keeps, hidden = {}, {}
    for where, mdl, msh, tk in (("card", card32, mesh, toks),
                                ("cpu", cpu32, cpu_mesh, toks.cpu())):
        r, mk = ep_slot_recorder()
        with wrapped(moe_lib, "dispatch_slots", mk), no_kernel_launches(label):
            h, _, _ = lm_apply(mdl, tk, ctx=ShardCtx(msh, decode_act_rules(msh)),
                               compute_dtype=torch.float32, logits_mode="none")
        keeps[where], hidden[where] = r, h.cpu()
    del card32, cpu32
    torch.cuda.empty_cache()
    kc, kp = keeps["card"]["keep"], keeps["cpu"]["keep"]
    same = sorted(kc) == sorted(kp) and all(torch.equal(kc[k], kp[k]) for k in kc)
    h_rel = rel(hidden["card"], hidden["cpu"])
    log(f"lm[{label}]: the first {layers} layers in float32, 1 x {n_tok} tokens, EP on "
        f"the card and on 4 CPU shards: {len(kc)} shard masks, kept {keeps['card']['kept']} "
        f"/ {keeps['cpu']['kept']} of {keeps['card']['routed']} routed slots; masks "
        f"bit-equal {same}; hidden states relative L2 {h_rel:.3e}")
    # Full depth in float32: the model converted in place.
    t0 = time.perf_counter()
    model.float()
    torch.cuda.synchronize()
    log(f"lm[{label}]: the model converted to float32 in place in "
        f"{time.perf_counter() - t0:.1f}s ({torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"held)")
    with no_kernel_launches(label):
        d32, d32_s, fed32 = run(EP_NO_DROP, False, dtype=torch.float32, toks=tokens[:1])
        rec3, make3 = ep_slot_recorder()
        with wrapped(moe_lib, "dispatch_slots", make3):
            e32, e32_s, _ = run(EP_NO_DROP, True, fed32, dtype=torch.float32,
                                toks=tokens[:1])
    f32_rel = rel(e32, d32)
    same_tokens = bool(torch.equal(e32.argmax(-1), d32.argmax(-1)))
    del e32, d32
    torch.cuda.empty_cache()
    log(f"lm[{label}]: float32 at full depth, 1 x {S} prompt tokens + {new - 1} decoded "
        f"positions, nothing dropped ({rec3['kept']} of "
        f"{rec3['routed']} slots): logits relative L2 {f32_rel:.3e} against the dense path "
        f"(tol {EP_F32_BAR:g}), greedy tokens equal {same_tokens}; prefill {e32_s:.3f} s "
        f"EP, {d32_s:.3f} s dense; {CARD}")
    checks = {
        f"nothing dropped at capacity {EP_NO_DROP:g}": rec["routed"] > 0
        and rec["kept"] == rec["routed"] and rec3["kept"] == rec3["routed"],
        f"float32 EP logits within {EP_F32_BAR:g} of the dense path at full depth":
            f32_rel <= EP_F32_BAR and same_tokens,
        f"{m.num_layers} EP layers x 4 shards a forward": len(rec["keep"]) ==
        4 * m.num_layers * new,
        "the kept slots of each shard bit-equal card vs 4 CPU shards": same
        and len(kc) == 4 * layers,
    }
    report(label, checks, kind="lm")
    return {"bf16_rel_l2": bf16_rel, "f32_rel_l2": f32_rel, "dropped": dropped,
            "routed": rec2["routed"], "prefill_s": ep_s, "dense_prefill_s": dense_s,
            "cpu_masks_equal": same}

def lm_phases():
    """8h: gemma3-4b's prefill_32k and decode_32k cells at full width and
    depth, qwen2-moe-a2.7b through the dense MoE path at full width and
    depth, and qwen3-32b and phi3.5-moe at full width, cut depth."""
    import torch
    from repro_torch.models import moe as moe_lib

    torch.cuda.empty_cache()
    out = {}
    arch, model = lm_prefill_phase()
    out["gemma3-4b decode_32k"] = lm_decode_phase(arch, model)
    del model
    torch.cuda.empty_cache()
    arch, model = lm_model("qwen2-moe-a2.7b")
    out["qwen2-moe-a2.7b"] = lm_generate_phase("qwen2-moe-a2.7b", arch, model, *LM_MOE,
                                               aux_of=moe_lib)
    out["qwen2-moe-a2.7b ep"] = lm_ep_phase(arch, model)
    del model
    torch.cuda.empty_cache()
    for name, layers in LM_CUT:
        arch, model = lm_model(name, layers)
        out[name] = lm_generate_phase(f"{name} {layers} layers", arch, model, *LM_CUT_RUN,
                                      aux_of=moe_lib if arch.model.moe else None)
        del model
        torch.cuda.empty_cache()
    return out


def lm_reference_check(name):
    """The smoke config's greedy ``LMEngine.generate`` in f32 on the card
    against the same on the CPU, same params and prompts: token ids
    equal, every step's logits within LM_F32_REL, no kernel launched."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer_lm as lm
    from repro_torch.models.params import init_model
    from repro_torch.serving.engine import LMEngine

    m = get_smoke_config(name).model
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, m.vocab_size, (2, 12)))
    toks, logits = {}, {}
    for dev in ("cuda", "cpu"):
        model = init_model(m, seed=1, device="cpu").to(dev)
        rec = []

        def keep(out):
            rec.append(out[0][:, -1].float().cpu())
            return out

        eng = LMEngine(
            lambda t: keep(lm.lm_prefill(model, t, m, 32, compute_dtype=torch.float32)),
            lambda t, c, i: keep(lm.lm_decode_step(model, t, c, i, m,
                                                   compute_dtype=torch.float32)),
            max_len=32)
        with no_kernel_launches(f"{name} smoke on {dev}"):
            toks[dev] = eng.generate(prompt.to(dev), 8).cpu()
        logits[dev] = torch.stack(rec)
    err = ((logits["cuda"] - logits["cpu"]).abs().max()
           / logits["cpu"].abs().max()).item()
    ok = torch.equal(toks["cuda"], toks["cpu"]) and err <= LM_F32_REL
    log(f"reference[lm {name}]: smoke config, f32 greedy generate of 8 tokens on 2 x 12 "
        f"prompts, card vs CPU: token ids equal {torch.equal(toks['cuda'], toks['cpu'])}, "
        f"logits max abs error / max abs {err:.3e} (tol {LM_F32_REL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("card LM trajectory disagrees with the CPU reference")


PATTERN_DIR = os.path.join(ROOT, "build", "patterns")
# The default template at the served grid (8, 32, 32) + 256 text tokens,
# frame_diag(window=1, sink=1) in 128 x 128 tiles: (FULL, PARTIAL, SKIP).
STATIC_SHARES = (0.280, 0.0, 0.720)


def pattern_search_phase():
    """The port's ``pattern_search`` on the card at the served vDiT grid
    (8, 32, 32): 24 heads of 128, 1 layer, 1 prompt, 2 steps of its
    synthetic calibration traffic, the reference's defaults otherwise
    (128 x 128 blocks, 25 dB).  It writes its artifact under the
    git-ignored ``build/patterns/``.  Returns the artifact's path."""
    import collections

    import torch
    from repro_torch.launch import pattern_search

    path = os.path.join(PATTERN_DIR, "vdit.json")
    t0 = time.perf_counter()
    art = pattern_search.main(["--grid", "8x32x32", "--layers", "1", "--heads", "24",
                               "--d", "128", "--prompts", "1", "--steps", "2",
                               "--out", path])
    torch.cuda.synchronize()
    log(f"pattern_search[vdit]: grid (8, 32, 32), 24 heads x 128, 1 layer, 1 prompt, "
        f"2 steps: static share {art.static_fraction():.4f}; branches "
        f"{dict(collections.Counter(art.branches(24)))}; version {art.version}; "
        f"{time.perf_counter() - t0:.1f}s; {CARD}")
    return path


def serve_static(arch, shape, model, latents=None):
    """``--policy static`` on the served vDiT with no artifact installed:
    the default template on every head, its plan built once, no bias
    (the map has no PARTIAL tile), and only the sparse kernel: one launch
    a layer-step.  Each request's latents go into ``latents`` by seed."""
    from repro_torch.core import patterns
    from repro_torch.kernels.sparse import ops as sparse_ops

    patterns.set_active_artifact(None)
    patterns.clear_plans()
    builds0 = patterns.plan_builds
    shapes, maps, biases = set(), {}, []
    with wrapped(sparse_ops, "sparse_attention", sparse_recorder(shapes, maps, biases)):
        counts, _, _ = serve_phase("static", arch, shape, model, policy="static",
                                   launched=("sparse_attention",),
                                   absent=("ripple_attention", "fused_reuse"),
                                   latents=latents)
    by_shape = dict(sparse_ops.launches_by_shape)  # read with ``counts``
    builds = patterns.plan_builds - builds0
    store = patterns.plan_store()
    shares = map_shares(maps)
    want = arch.model.num_layers * shape.steps
    log(f"serve[static]: sparse launches {counts['sparse_attention']} (expected "
        f"{want}), by (tokens, head dim) {sorted(by_shape.items())}; calls at "
        f"(tokens, head dim, tensor cores) {sorted(shapes)}; "
        f"tile shares full {shares[0]:.4f} partial {shares[1]:.4f} skip "
        f"{shares[2]:.4f} (expected {STATIC_SHARES}); calls with a bias "
        f"{sum(biases)}; plan builds {builds} for {len(store)} keys {list(store)}")
    if counts["sparse_attention"] != want:
        raise SystemExit("serve[static]: a layer-step missed the sparse kernel")
    if tuple(round(x, 3) for x in shares) != STATIC_SHARES:
        raise SystemExit("serve[static]: the served map has other tiles")
    if any(biases) or any(p.bias is not None for p in store.values()):
        raise SystemExit("serve[static]: a bias was built for a PARTIAL-free map")
    if builds != len(store) or len(store) != 1:
        raise SystemExit("serve[static]: the constant plan was built more than "
                         "once per key")
    return counts


def serve_rainfusion(arch, shape, model, path):
    """``--policy rainfusion`` on the served vDiT with the artifact of
    :func:`pattern_search_phase` installed: fused_reuse snaps the dynamic
    heads, the sparse kernel runs every head under the static heads' maps
    and their bias, the ripple kernel never launches."""
    import torch
    from repro_torch.core import patterns
    from repro_torch.kernels.sparse import ops as sparse_ops

    art = patterns.install_artifact(path)
    patterns.clear_plans()  # installing keeps the store: count this phase's plans
    heads = arch.model.num_heads
    static = [h for h in range(heads) if art.assignment(None, h) is not None]
    builds0 = patterns.plan_builds
    shapes, maps, biases = set(), {}, []
    with wrapped(sparse_ops, "sparse_attention", sparse_recorder(shapes, maps, biases)):
        counts, _, _ = serve_phase("rainfusion", arch, shape, model,
                                   policy="rainfusion",
                                   launched=("fused_reuse", "sparse_attention"),
                                   absent=("ripple_attention",))
    store = patterns.plan_store()
    shares = map_shares(maps)
    bias_gb = sum(p.bias.numel() * 4 for p in store.values() if p.bias is not None) / 1e9
    log(f"serve[rainfusion]: artifact {art.version}: {len(static)} of {heads} heads "
        f"static {static}; launches fused_reuse {counts['fused_reuse']}, sparse "
        f"{counts['sparse_attention']}; calls with a bias {sum(biases)} of "
        f"{len(biases)}; tile shares full {shares[0]:.4f} partial {shares[1]:.4f} "
        f"skip {shares[2]:.4f}; plan builds {patterns.plan_builds - builds0} for "
        f"{len(store)} keys, stored bias {bias_gb:.2f} GB")
    if patterns.plan_builds - builds0 != len(store) or len(store) > 1:
        raise SystemExit("serve[rainfusion]: a constant plan was built more than once")
    patterns.set_active_artifact(None)
    patterns.clear_plans()  # its 6.85 GB bias
    torch.cuda.empty_cache()
    return counts


def serve_policies(arch, shape, model, art_path, want):
    """Per-request policies in one engine: the launcher's
    ``make_sampler_factory`` on the loaded model, four requests (seeds 0
    and 1, each under ripple and under static with no artifact, so on
    the default template) in two buckets of two, the launch counters set
    to 0 just before and read just after, and each bucket's launches
    read around its batch.  A denoise hook installs the searched
    artifact between steps ``steps // 2 - 1`` and ``steps // 2`` of the
    static batch: that batch keeps its pinned template (its map shares
    and sparse launches are those of ``serve[static]``), and a fifth
    request, static again, gets a bucket of its own whose token is the
    new artifact's version.  Each of the four requests' latents is held
    within relative L2 1e-3 of the same seed's in ``serve[ripple]`` /
    ``serve[static]`` (``want``: policy -> seed -> latents).  The ripple
    batch must launch fused_reuse twice and ripple once a layer-step, the
    static batch the sparse kernel once a layer-step and nothing else,
    and no plain version may run on the card."""
    import numpy as np
    import torch
    from repro_torch.core import patterns
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.sparse import ops as sparse_ops
    from repro_torch.launch.serve import make_sampler_factory
    from repro_torch.launch.workloads import mixed_request_stream
    from repro_torch.serving.engine import DiffusionEngine

    patterns.set_active_artifact(None)
    swap_at = shape.steps // 2
    swapped = []

    def hooked(*a, **kw):
        # The static bucket's denoise call at step ``swap_at``: install
        # the searched artifact before its forward runs.
        if (not swapped and kw["step"] == swap_at
                and get_policy(kw["ripple"].policy).name == "static"):
            swapped.append(patterns.install_artifact(art_path))
        return model(*a, **kw)

    factory, plan_fn = make_sampler_factory(arch, (shape,), hooked)
    batches = []  # (policy, launches, map shares) of each batch

    def counted(shp, steps, policy=None, reuse_every=None, stream_every=None):
        fn = factory(shp, steps, policy, reuse_every, stream_every)

        def run(noise, txt, seeds):
            shapes, maps = set(), {}
            before = launch_counts()
            with wrapped(sparse_ops, "sparse_attention", sparse_recorder(shapes, maps)):
                out = fn(noise, txt, seeds)
            after = launch_counts()
            # A static bucket's policy comes pinned: an instance.
            batches.append((getattr(policy, "name", policy),
                            {k: after[k] - before[k] for k in after},
                            map_shares(maps)))
            return out
        return run

    base = [req for _, req in mixed_request_stream(arch, (shape,), 2, seed=0)]
    reqs = [dataclasses.replace(base[i // 2], request_id=i, policy=pol)
            for i, pol in enumerate(("ripple", "static") * 2)]
    engine = DiffusionEngine(counted, device="cuda", max_batch=2, plan_fn=plan_fn)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for req in reqs:  # all queued before the worker starts: one batch a bucket
        engine.submit(req)
    with plain_guard(vdit_plain_versions()) as plain:
        engine.start()
        try:
            results = [engine.result(req.request_id) for req in reqs]
            torch.cuda.synchronize()
            counts = launch_counts()
            keys = list(engine._compiled)
            after = dataclasses.replace(base[0], request_id=4, policy="static")
            engine.submit(after)
            res_after = engine.result(4)
        finally:
            engine.stop()
    wall = time.perf_counter() - t0
    keys_after = list(engine._compiled)
    errs = {}
    for req, r in zip(reqs, results):
        ref = want[req.policy][req.seed]
        errs[req.request_id] = float(np.linalg.norm(r.latents - ref) / np.linalg.norm(ref))
        log(f"serve[policies]: request {req.request_id} ({req.policy}, seed {req.seed}) "
            f"latency {r.latency_s:.3f}s (batch {r.batch_index} served in "
            f"{r.walltime_s:.3f}s); relative L2 to serve[{req.policy}]'s seed "
            f"{req.seed}: {errs[req.request_id]:.3e} (tol 1e-3); {CARD}")
    log(f"serve[policies]: request 4 (static, after the swap) latency "
        f"{res_after.latency_s:.3f}s; bucket keys {keys} then {keys_after[-1]}; "
        f"swapped in artifact {swapped[0].version if swapped else None} at step "
        f"{swap_at}; launches of the first two batches {counts}; plain versions "
        f"called on the card {plain}; {wall:.1f}s; {CARD}")
    for pol, launched, shares in batches:
        log(f"serve[policies]: batch ({pol}): launches {launched}; tile shares full "
            f"{shares[0]:.4f} partial {shares[1]:.4f} skip {shares[2]:.4f}")
    by_pol = {pol: (launched, shares) for pol, launched, shares in batches[:2]}
    rip, (st, st_shares) = by_pol["ripple"][0], by_pol["static"]
    layer_steps = arch.model.num_layers * shape.steps
    checks = {
        "two buckets that differ in the policy, each with its policy's token":
            len(keys) == 2 and {k[2] for k in keys} == {"ripple", "static"}
            and all(k[7] is None for k in keys),
        "the ripple batch launched fused_reuse twice and ripple once a "
        "layer-step, nothing else":
            rip["fused_reuse"] == 2 * layer_steps
            and rip["ripple_attention"] == layer_steps
            and rip["sparse_attention"] == 0,
        "the static batch launched the sparse kernel only, once a layer-step":
            st["sparse_attention"] == layer_steps and st["fused_reuse"] == 0
            and st["ripple_attention"] == 0,
        "no plain version ran on the card": not any(plain.values()),
        "the swap landed inside the static batch": len(swapped) == 1,
        "the static batch kept its template across the swap":
            tuple(round(x, 3) for x in st_shares) == STATIC_SHARES,
        "the next static request got a bucket with the new version":
            len(keys_after) == 3 and keys_after[-1][2] == "static"
            and bool(swapped) and keys_after[-1][7] == swapped[0].version
            and keys_after[-1][:7] == next(k for k in keys if k[2] == "static")[:7],
        "latents within 1e-3 of serve[ripple] / serve[static]":
            all(e < 1e-3 for e in errs.values()),
    }
    for what, ok in checks.items():
        log(f"serve[policies]: {what}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("serve[policies] failed")
    patterns.set_active_artifact(None)
    patterns.clear_plans()
    torch.cuda.empty_cache()
    return counts


def recording(streams):
    """A ``wrapped`` maker for ``DiffusionEngine.stream``: each chunk the
    engine hands out goes into ``streams[request_id]`` too."""
    def make(orig):
        def stream(self, request_id, timeout=3600.0):
            for chunk in orig(self, request_id, timeout):
                streams.setdefault(request_id, []).append(chunk)
                yield chunk
        return stream
    return make


LAUNCHER_LAYERS = 8       # serve[launcher]: vdit-paper depth 40 cut to 8
LAUNCHER_STREAM = 4       # --stream-every
LAUNCHER_ARGV = ["--arch", "vdit-paper", "--steps", "12", "--requests", "6",
                 "--max-batch", "2", "--stream-every", str(LAUNCHER_STREAM),
                 "model.frames=32", f"model.num_layers={LAUNCHER_LAYERS}"]


def serve_launcher():
    """``repro_torch.launch.serve.main`` itself on the card: vdit-paper at
    full width, depth cut to 8 layers (and frames to 32) so the phase
    stays short, 12 steps, 6 requests over the launcher's mixed buckets
    (grid (8, 32, 32) at 12 and 6 steps, (8, 16, 16) at 12), batches of
    2, streamed every 4 steps, with its summary written to a temporary
    directory; the launch counters are set to 0 just before and read
    just after.  Each request's chunks are read as the launcher's
    ``stream`` hands them out: there must be ceil(steps / 4) of them,
    the last equal to the result, and on the 12-step buckets the TTFF
    below the latency.  fused_reuse must launch twice and ripple once a
    layer-step, and no plain version may run on the card.  Afterwards
    each served batch runs again in one piece, through the launcher's own
    sampler factory without ``stream_every``, on the same noise, text
    and model: every streamed result must equal it bit for bit.  Returns
    the launch counts and the results by request id."""
    import json
    import math
    import tempfile

    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as serve_lib
    from repro_torch.serving import engine as engine_lib

    streams, seen = {}, {}

    def keeping(name):
        # The launcher's sampler factory and traffic, kept for the run in
        # one piece.
        def make(orig):
            def f(*a, **kw):
                seen[name] = out = orig(*a, **kw)
                return out
            return f
        return make

    log(f"serve[launcher]: python -m repro_torch.launch.serve, vdit-paper full width; "
        f"cuts: frames 128->32, layers 40->{LAUNCHER_LAYERS} (to keep the phase "
        f"short), 12 DDIM steps; 6 requests, batches of 2, --stream-every "
        f"{LAUNCHER_STREAM}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "summary.json")
        argv = LAUNCHER_ARGV + ["--summary-json", path]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with wrapped(engine_lib.DiffusionEngine, "stream", recording(streams)), \
                wrapped(serve_lib, "make_sampler_factory", keeping("factory")), \
                wrapped(serve_lib, "mixed_request_stream", keeping("traffic")), \
                plain_guard(vdit_plain_versions()) as plain:
            done = serve_lib.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with open(path, encoding="utf-8") as f:
            summary = json.load(f)
    # Each batch again in one piece (the launch counts are read already).
    factory = seen["factory"][0]
    reqs = {req.request_id: req for _, req in seen["traffic"]}
    whole = {}
    for bi in sorted({r.batch_index for r in done}):
        batch = sorted((r.request_id for r in done if r.batch_index == bi))
        req = reqs[batch[0]]
        fn = factory(req.latent_shape, req.steps, req.policy, req.reuse_every, None)
        noise = torch.stack([engine_lib.request_noise(reqs[i].seed, req.latent_shape,
                                                      "cuda") for i in batch])
        txt = torch.from_numpy(np.stack([reqs[i].txt for i in batch])).float().cuda()
        out = fn(noise, txt, [reqs[i].seed for i in batch])
        lat = (out[0] if isinstance(out, tuple) else out).float().cpu().numpy()
        whole.update(zip(batch, lat))
    del factory, fn, seen
    torch.cuda.synchronize()
    steps = {0: 12, 1: 12, 2: 6}  # round-robin over base, _r256, _s6
    chunk_ok, ttff_ok, whole_ok = True, True, True
    buckets = set()
    for r in done:
        n_steps = steps[r.request_id % 3]
        buckets.add((r.latents.shape, n_steps))
        chunks = streams.get(r.request_id, [])
        same = bool(chunks) and np.array_equal(chunks[-1], r.latents)
        chunk_ok &= len(chunks) == math.ceil(n_steps / LAUNCHER_STREAM) and same
        one = whole.get(r.request_id)
        equal = one is not None and np.array_equal(one, r.latents)
        whole_ok &= equal
        if n_steps == 12:
            ttff_ok &= 0 <= r.ttff_s < r.latency_s
        log(f"serve[launcher]: request {r.request_id} ({n_steps} steps, latents "
            f"{r.latents.shape}) latency {r.latency_s:.3f}s, ttff {r.ttff_s:.3f}s, "
            f"{len(chunks)} chunks, last chunk equals the result: {same}, result "
            f"equals the run in one piece: {equal}; batch {r.batch_index} served "
            f"in {r.walltime_s:.3f}s; {CARD}")
    log(f"serve[launcher]: summary {summary}; launches {counts}; plain versions "
        f"called on the card {plain}; {wall:.1f}s with the model's init; {CARD}")
    layer_steps = LAUNCHER_LAYERS * sum(
        {r.batch_index: steps[r.request_id % 3] for r in done}.values())
    checks = {
        "all 6 requests completed": summary["completed"] == list(range(6))
        and not summary["errors"],
        "no degradation, retry, quarantine or watchdog trip":
            quiet_counters(summary),
        "3 buckets served": len(buckets) == 3
        and summary["counters"].get("batches_served") == 3,
        "ceil(steps / 4) chunks a request, the last equal to the result": chunk_ok,
        "each streamed result equals the batch run in one piece, bit for bit":
            whole_ok,
        "TTFF below the latency on the 12-step buckets": ttff_ok,
        "fused_reuse twice and ripple once a layer-step":
            counts["fused_reuse"] == 2 * layer_steps
            and counts["ripple_attention"] == layer_steps,
        "no plain version ran on the card": not any(plain.values()),
        "finite latents": all(np.isfinite(r.latents).all() for r in done),
    }
    for what, ok in checks.items():
        log(f"serve[launcher]: {what}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("serve[launcher] failed")
    torch.cuda.empty_cache()
    return counts, {r.request_id: r for r in done}


# The counters a fault-free launcher run must leave at 0 (guardrails are
# on by default: a kernel returning NaN would otherwise be served quietly
# through the dense rung).
QUIET_COUNTERS = ("degraded_count", "dense_fallbacks", "batch_retries",
                  "quarantined", "watchdog_trips")
CONTROL_CUT = ("model.frames=32", f"model.num_layers={LAUNCHER_LAYERS}")
HANG_TIMEOUT_S = 8.0  # serve[failover]'s --batch-timeout: ~4x a batch here
# The hung batch's sleep: past the watchdog, then it runs and ends.  Its
# worker holds the replica's model until then (about 8 GiB at 8 layers),
# so the phase waits for it.
HANG_SLEEP_S = 20.0


def quiet_counters(summary) -> bool:
    """Every :data:`QUIET_COUNTERS` entry of the summary (and of each
    router replica's) is 0, and the keys are there."""
    c = summary["counters"]
    found = [k for k in c if k.split("_", 1)[-1] in QUIET_COUNTERS
             or k in QUIET_COUNTERS]
    return bool(found) and not any(c[k] for k in found)


def run_launcher(label, argv):
    """``repro_torch.launch.serve.main(argv)`` with the summary in a
    temporary directory, and the engine's internals shadowed to record,
    in order: each attempt's launches (``_run_batch``; exact only when
    one engine runs), each published batch's members and latents
    (``_publish_batch``), each batch's sentinel readings
    (``_sentinel_verdict``) and each watchdog trip with the engine's
    health after it.  Any fault plan is cleared at the end."""
    import json
    import tempfile

    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve as serve_lib
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving import faults as fault_lib

    rec = {"attempts": [], "published": [], "aux": [], "trips": []}

    def attempts(orig):
        def f(self, key, batch, policy, pub, abandoned, *budget):
            before = launch_counts()
            out = orig(self, key, batch, policy, pub, abandoned, *budget)
            after = launch_counts()
            rec["attempts"].append((key[2], sorted(r.request_id for _, r, _ in batch),
                                    {k: after[k] - before[k] for k in after
                                     if after[k] != before[k]}))
            return out
        return f

    def published(orig):
        def f(self, batch, lat, dt, pub, err, degraded):
            if err is None:
                rids = sorted(r.request_id for _, r, _ in batch)
                rec["published"].append((id(self), rids, {
                    r.request_id: np.array(lat[i]) for i, (_, r, _) in enumerate(batch)}))
            return orig(self, batch, lat, dt, pub, err, degraded)
        return f

    def verdict(orig):
        def f(self, lat, aux):
            rec["aux"].append({k: float(v) for k, v in (aux or {}).items()})
            return orig(self, lat, aux)
        return f

    def trip(orig):
        def f(self, *a, **kw):
            orig(self, *a, **kw)
            rec["trips"].append(self.healthy())
        return f

    log(f"serve[{label}]: python -m repro_torch.launch.serve {' '.join(argv)}")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "summary.json")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with wrapped(engine_lib.DiffusionEngine, "_run_batch", attempts), \
                    wrapped(engine_lib.DiffusionEngine, "_publish_batch", published), \
                    wrapped(engine_lib.DiffusionEngine, "_sentinel_verdict", verdict), \
                    wrapped(engine_lib.DiffusionEngine, "_trip_watchdog", trip):
                done = serve_lib.main(argv + ["--summary-json", path])
            torch.cuda.synchronize()
            rec["wall"] = time.perf_counter() - t0
            with open(path, encoding="utf-8") as f:
                rec["summary"] = json.load(f)
    finally:
        fault_lib.clear_faults()
    rec["done"] = {r.request_id: r for r in done}
    log(f"serve[{label}]: {rec['wall']:.1f}s with the model's init; completed "
        f"{rec['summary']['completed']}, errors {rec['summary']['errors']}, shed "
        f"{rec['summary']['shed']}; {CARD}")
    return rec


def batch_of(rec, rid, lat):
    """The members of the published batch that produced ``lat`` for
    ``rid`` (a request served twice, by a zombie batch and by its new
    replica, has two)."""
    import numpy as np

    for _, rids, lats in rec["published"]:
        if rid in lats and np.array_equal(lats[rid], lat):
            return rids
    return None


def rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def report(label, checks, kind="serve"):
    for what, ok in checks.items():
        log(f"{kind}[{label}]: {what}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit(f"{kind}[{label}] failed")


def serve_slo():
    """Deadlines and admission on the launcher's 8-layer vDiT, through
    engines built on ``make_sampler_factory`` (guardrails on).  One warm
    batch of 2 at (8, 32, 32), 12 steps, gives the shared estimator its
    lower bound L.  A fresh engine sharing it (not started, so the queue
    depth at each submit is known) gets six requests of that bucket with
    deadlines at -1 s and 0.5, 1.5, 1.5, 1.5, 2.5 L from their submit:
    the requests shed must be exactly those ``admission_decision``
    proves from L and the depth (the first, second and fifth), and the
    rest are served.  Then two fresh engines, edf and hottest, each get
    two requests of the (8, 32, 32) 6-step bucket (deadline 60 s) and one
    of the (8, 16, 16) 12-step bucket (deadline 30 s), queued before the
    worker starts: edf must serve the 30 s bucket first, hottest the
    deeper one.  In every engine completed + shed = submitted, and met +
    missed = completed."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch.workloads import mixed_gen_shapes, mixed_request_stream
    from repro_torch.serving.engine import DiffusionEngine
    from repro_torch.serving.slo import ServiceEstimator, ShedError, admission_decision

    arch = apply_overrides(get_config("vdit-paper"), CONTROL_CUT)
    shapes = mixed_gen_shapes(arch, base=serve_lib.serving_shape(
        arch, "gen_512", smoke=False, steps=12))
    log(f"serve[slo]: vdit-paper full width, {LAUNCHER_LAYERS} layers, buckets "
        f"{[(sp.name, sp.img_res, sp.steps) for sp in shapes]}, batches of 2")
    t0 = time.perf_counter()
    model = serve_lib.MODEL_INIT["vdit"](arch.model, seed=0, device="cuda")
    factory, _ = serve_lib.make_sampler_factory(arch, shapes, model, device="cuda",
                                                sentinel=True)
    # Round robin: ids 0, 3, ... the 12-step (8, 32, 32) bucket; 1, 4, ...
    # (8, 16, 16); 2, 5, ... the 6-step one.
    traffic = [req for _, req in mixed_request_stream(arch, shapes, 12, seed=0,
                                                       policy="ripple")]
    engines = []

    def engine(est, scheduler="edf"):
        eng = DiffusionEngine(factory, device="cuda", max_batch=2, estimator=est,
                              scheduler=scheduler, guardrail=True)
        engines.append(eng)
        return eng

    def served(eng, reqs):
        eng.start()
        try:
            return {r.request_id: eng.result(r.request_id) for r in reqs}
        finally:
            eng.stop()

    est = ServiceEstimator()
    eng = engine(est)
    for req in (traffic[0], traffic[3]):  # queued first: one batch of 2
        eng.submit(req)
    warm = served(eng, [traffic[0], traffic[3]])
    key = eng._bucket_key(traffic[0])
    L, ewma = est.lower_bound(key), est.expected(key)
    log(f"serve[slo]: warm batch of 2 served in {warm[0].walltime_s:.3f}s; bucket "
        f"{key[:3]}: lower bound L {L:.4f}s, EWMA {ewma:.4f}s; {CARD}")
    eng = engine(est)
    margins = (None, 0.5, 1.5, 1.5, 1.5, 2.5)   # None: a deadline 1 s ago
    reqs = [dataclasses.replace(traffic[6], request_id=100 + j, seed=100 + j)
            for j in range(len(margins))]
    proved, shed, admitted, submit_t = set(), set(), [], {}
    for req, m in zip(reqs, margins):
        now = submit_t[req.request_id] = time.time()
        req.deadline_s = now - 1.0 if m is None else now + m * L
        if admission_decision(req.deadline_s, now, len(admitted), 2, L) is not None:
            proved.add(req.request_id)
        try:
            eng.submit(req)
            admitted.append(req)
        except ShedError as e:
            shed.add(req.request_id)
            log(f"serve[slo]: {e}")
    res = served(eng, admitted)
    for req in admitted:
        r = res[req.request_id]
        budget = req.deadline_s - submit_t[req.request_id]
        margin = budget - r.latency_s
        log(f"serve[slo]: request {r.request_id} (deadline {budget:.3f}s after "
            f"submit) latency {r.latency_s:.3f}s, batch {r.batch_index} in "
            f"{r.walltime_s:.3f}s, deadline {'met' if r.deadline_met else 'MISSED'}, "
            f"margin {margin:.3f}s; {CARD}")
    order, served_n = {}, []
    for scheduler in ("edf", "hottest"):
        e2 = engine(ServiceEstimator(), scheduler)
        now = time.time()
        q = [dataclasses.replace(traffic[i], deadline_s=now + dl)
             for i, dl in ((2, 60.0), (5, 60.0), (1, 30.0))]
        for r in q:
            e2.submit(r)
        got = served(e2, q)
        served_n.append(len(got))
        first = min(got.values(), key=lambda r: r.batch_index)
        order[scheduler] = first.request_id
        log(f"serve[slo]: {scheduler}: batches "
            f"{sorted((r.batch_index, r.request_id) for r in got.values())}, first "
            f"request {first.request_id}; latencies "
            f"{[round(got[r.request_id].latency_s, 3) for r in q]}s; {CARD}")
    wall = time.perf_counter() - t0
    metrics = [e.metrics() for e in engines]
    for e, m in zip(engines, metrics):
        log(f"serve[slo]: engine {e.scheduler} counters {m}")
    subs = [2, len(reqs), 3, 3]
    checks = {
        "the shed requests are exactly those admission_decision proves":
            shed == proved == {100, 101, 104},
        "every admitted request served, finite":
            len(res) == 3 and all(np.isfinite(r.latents).all() for r in res.values()),
        "edf serves the earlier feasible deadline first": order["edf"] == 1,
        "hottest serves the deepest bucket first": order["hottest"] in (2, 5),
        "completed + shed = submitted in every engine":
            [len(warm), len(res), *served_n] == [s - m["shed_count"]
                                                 for s, m in zip(subs, metrics)],
        "met + missed = completed with a deadline":
            [m["deadlines_met"] + m["deadlines_missed"] for m in metrics]
            == [0, 3, 3, 3],
        "no degradation": all(m["degraded_count"] == 0 for m in metrics),
    }
    log(f"serve[slo]: {wall:.1f}s the phase with the model's init; {CARD}")
    report("slo", checks)
    del model, factory
    torch.cuda.empty_cache()


def serve_failover():
    """The launcher with ``--replicas 2`` on the 8-layer vDiT (6 requests
    over its 3 mixed buckets, 12 steps, batches of up to 2): fault-free,
    then with ``kill_replica:after=1`` (the deeper replica is failed
    after the first result and its unserved requests requeue), then with
    ``hang:count=1`` under ``--batch-timeout 8`` (the first batch sleeps
    HANG_SLEEP_S before its sampler runs; the watchdog trips once and
    takes that replica down; the phase ends once the hung worker has).  Every request completes without an error, and each
    result equals the fault-free run's bit for bit where its batch has
    the same members, else within relative L2 1e-3.  The latencies of
    the fault runs share the card with the zombie batch of the failed
    replica."""
    import threading

    import numpy as np

    base = ["--arch", "vdit-paper", "--steps", "12", "--requests", "6",
            "--max-batch", "2", "--replicas", "2", *CONTROL_CUT]
    ref = run_launcher("failover", base)
    checks = {"fault-free: every request completed":
              sorted(ref["summary"]["completed"]) == list(range(6))
              and not ref["summary"]["errors"],
              "fault-free: no degradation, retry, quarantine or watchdog trip":
              quiet_counters(ref["summary"])}
    for label, extra in (("kill_replica", ["--inject-faults", "kill_replica:after=1"]),
                         ("hang", ["--inject-faults",
                                   f"hang:count=1,seconds={HANG_SLEEP_S:g}",
                                   "--batch-timeout", str(HANG_TIMEOUT_S)])):
        rec = run_launcher(f"failover {label}", base + extra)
        if label == "hang":  # the engine's batch workers run ``work``
            t0 = time.perf_counter()
            for t in threading.enumerate():
                if t.name.endswith("(work)"):
                    t.join(timeout=HANG_SLEEP_S + 120)
            log(f"serve[failover hang]: waited {time.perf_counter() - t0:.1f}s for the "
                f"hung worker; batch workers left "
                f"{sum(t.name.endswith('(work)') for t in threading.enumerate())}")
        c = rec["summary"]["counters"]
        bitwise, close, worst = [], [], 0.0
        for rid, r in sorted(rec["done"].items()):
            want = ref["done"][rid].latents
            same = batch_of(rec, rid, r.latents) == batch_of(ref, rid, want)
            err = rel_l2(r.latents, want)
            worst = max(worst, err)
            (bitwise if same else close).append(rid)
            log(f"serve[failover {label}]: request {rid} latency {r.latency_s:.3f}s "
                f"(shared with a zombie batch), batch "
                f"{batch_of(rec, rid, r.latents)} against "
                f"{batch_of(ref, rid, want)}: bit-equal "
                f"{np.array_equal(r.latents, want)}, relative L2 {err:.3e}; {CARD}")
        log(f"serve[failover {label}]: counters {c}")
        checks[f"{label}: every request completed without an error"] = (
            sorted(rec["summary"]["completed"]) == list(range(6))
            and not rec["summary"]["errors"])
        checks[f"{label}: bit-equal where the batch has the same members"] = all(
            np.array_equal(rec["done"][i].latents, ref["done"][i].latents)
            for i in bitwise)
        checks[f"{label}: within relative L2 1e-3 elsewhere"] = worst < 1e-3
        if label == "kill_replica":
            checks["kill_replica: router_requeued >= 1"] = c["router_requeued"] >= 1
        else:
            trips = sum(v for k, v in c.items() if k.endswith("watchdog_trips"))
            checks["hang: the watchdog tripped once and its replica went down"] = (
                trips == 1 and rec["trips"] == [False])
    report("failover", checks)


def serve_guardrail():
    """The guardrail ladder on the launcher's 8-layer vDiT (gen_512 at
    grid (8, 32, 32), 2 requests in one batch, 4 steps) with
    ``attn_nan:step=1``: the ripple batch launches fused_reuse and
    ripple, trips, and is served again under dense with neither kernel
    launched; its results are finite, degraded, and bit-equal to the same
    batch under ``--policy dense`` (run next, fault-free).  A static
    batch (the grid's default template) runs three attempts: the sparse
    kernel only, then fused_reuse + ripple, then neither.  Then, without
    a fault, 12 steps under ``--reuse-every 4
    ripple.sentinel_probe_every=4``: the drift probe (the served
    attention of head 0 against a dense f32 recompute, at steps 0, 4 and
    8) must read finite.  Returns the launches of the fault runs by
    kernel."""
    import numpy as np
    from repro_torch.core import patterns

    common = ["--arch", "vdit-paper", "--shape", "gen_512", "--steps", "4",
              "--requests", "2", "--max-batch", "2", *CONTROL_CUT]
    fault = ["--inject-faults", "attn_nan:step=1"]
    layer_steps = LAUNCHER_LAYERS * 4
    patterns.set_active_artifact(None)  # static on the default template
    rip = run_launcher("guardrail ripple", common + fault)
    dense = run_launcher("guardrail dense", common + ["--policy", "dense"])
    stat = run_launcher("guardrail static", common + ["--policy", "static"] + fault)
    drift = run_launcher("guardrail drift", [
        "--arch", "vdit-paper", "--shape", "gen_512", "--steps", "12", "--requests",
        "2", "--max-batch", "2", "--reuse-every", "4", *CONTROL_CUT,
        "ripple.sentinel_probe_every=4"])
    for label, rec in (("ripple", rip), ("static", stat)):
        for pol, rids, launched in rec["attempts"]:
            log(f"serve[guardrail {label}]: attempt under {pol} for {rids}: "
                f"launches {launched}")
        log(f"serve[guardrail {label}]: sentinel readings {rec['aux']}; counters "
            f"{rec['summary']['counters']}")
    readings = drift["aux"][-1] if drift["aux"] else {}
    log(f"serve[guardrail drift]: sentinel_drift {readings.get('sentinel_drift')} "
        f"(the ripple kernel's output of head 0 against a dense f32 recompute, "
        f"max over steps 0, 4, 8), sentinel_nonfinite "
        f"{readings.get('sentinel_nonfinite')}, latent_nonfinite "
        f"{readings.get('latent_nonfinite')}; {CARD}")
    rc, sc = rip["summary"]["counters"], stat["summary"]["counters"]
    want = {"fused_reuse": 2 * layer_steps, "ripple_attention": layer_steps}
    checks = {
        "ripple: fused_reuse + ripple, then dense with neither":
            [(p, launched) for p, _, launched in rip["attempts"]]
            == [("ripple", want), ("dense", {})],
        "ripple: finite, degraded, degraded_count = dense_fallbacks = 1":
            all(np.isfinite(r.latents).all() and r.degraded
                for r in rip["done"].values()) and len(rip["done"]) == 2
            and rc["degraded_count"] == rc["dense_fallbacks"] == 1,
        "ripple: bit-equal to --policy dense": all(
            np.array_equal(r.latents, dense["done"][i].latents)
            for i, r in rip["done"].items()),
        "dense and drift: no degradation, retry, quarantine or watchdog trip":
            quiet_counters(dense["summary"]) and quiet_counters(drift["summary"]),
        "static: sparse only, then fused_reuse + ripple, then neither":
            [(p, launched) for p, _, launched in stat["attempts"]]
            == [("static", {"sparse_attention": layer_steps}), ("ripple", want),
                ("dense", {})],
        "static: degraded_count 2, finite":
            sc["degraded_count"] == 2 and sc["dense_fallbacks"] == 1
            and all(np.isfinite(r.latents).all() and r.degraded
                    for r in stat["done"].values()),
        "drift: sentinel_drift finite, no non-finite entry":
            np.isfinite(readings.get("sentinel_drift", np.nan))
            and readings.get("sentinel_nonfinite") == 0
            and readings.get("latent_nonfinite") == 0,
    }
    report("guardrail", checks)
    out = {}
    for rec in (rip, stat):
        for _, _, launched in rec["attempts"]:
            for k, v in launched.items():
                out[k] = out.get(k, 0) + v
    return out


JOURNAL_ROOT = os.path.join(ROOT, "build", "journal")  # git-ignored


def journal_dir(name):
    """An empty journal directory under ``build/journal``."""
    import shutil

    d = os.path.join(JOURNAL_ROOT, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(JOURNAL_ROOT, exist_ok=True)
    return d


def serve_crash(launcher_done):
    """The crash drill of DESIGN.md §18 on ``serve[launcher]``'s argv.
    First the launcher runs it in process with ``--journal`` (fsync
    ``always``): the journal's and the checkpoints' costs, and its
    latencies beside ``serve[launcher]``'s.  Then ``python -m
    repro_torch.launch.serve`` runs it in a subprocess with ``--journal
    DIR --inject-faults crash:after=1``: it must die by SIGKILL once a
    chunk checkpoint of work in flight is on disk.  ``recover(DIR)``
    must show a crash, pending requests and a checkpoint strictly inside
    its run.  The restart (``--journal DIR --resume --requests 0``, in
    process) must complete every recovered request from its checkpoint:
    ``recovered`` equal to the pending count, ``resumed_from_step`` > 0,
    ``checkpoint_writes`` > 0, the quiet counters 0, then a clean journal
    with nothing pending.  Each recovered request's latents must equal
    ``serve[launcher]``'s bit for bit where its batch has the same
    members, else within relative L2 1e-3, and each attempt of the
    restart must launch fused_reuse twice and ripple once a layer-step
    of the steps left after its resume step, exactly.  Returns the
    restart's launches by kernel."""
    import shutil

    import numpy as np
    from repro_torch.serving import journal as journal_lib

    d_on = journal_dir("launcher")
    on = run_launcher("crash journal", LAUNCHER_ARGV + ["--journal", d_on])
    c = on["summary"]["counters"]
    for rid, r in sorted(on["done"].items()):
        base = launcher_done[rid]
        log(f"serve[crash journal]: request {rid} latency {r.latency_s:.3f}s ttff "
            f"{r.ttff_s:.3f}s with --journal (fsync always), {base.latency_s:.3f}s / "
            f"{base.ttff_s:.3f}s in serve[launcher]; {CARD}")
    writes = max(c["checkpoint_writes"], 1)
    log(f"serve[crash journal]: checkpoint_writes {c['checkpoint_writes']}, "
        f"checkpoint_bytes {c['checkpoint_bytes']} ({c['checkpoint_bytes'] / writes:.0f} "
        f"a write), checkpoint_write_ms {c['checkpoint_write_ms']} "
        f"({c['checkpoint_write_ms'] / writes:.1f} a write); journal_appends "
        f"{c['journal_appends']}, journal_bytes {c['journal_bytes']}, journal_fsyncs "
        f"{c['journal_fsyncs']}, journal_fsync_ms {c['journal_fsync_ms']} "
        f"({c['journal_fsync_ms'] / max(c['journal_fsyncs'], 1):.2f} a fsync); "
        f"{CARD}")
    same = all(np.array_equal(r.latents, launcher_done[rid].latents)
               for rid, r in on["done"].items())

    d = journal_dir("crash")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCHER_ARGV,
           "--journal", d, "--inject-faults", "crash:after=1"]
    log(f"serve[crash]: {' '.join(cmd[1:])} (a subprocess)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_FAULTS", None)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                          stderr=subprocess.PIPE, timeout=300)
    crash_wall = time.perf_counter() - t0
    tail = proc.stderr.decode(errors="replace").strip().splitlines()[-4:]
    log(f"serve[crash]: returncode {proc.returncode} after {crash_wall:.1f}s "
        f"(process start, CUDA init and the model's init included); its last "
        f"log lines: {tail}")
    rec = journal_lib.recover(d)
    store = journal_lib.CheckpointStore(d)
    steps = {rid: int(r["steps"]) for rid, r in rec.pending.items()}
    resume_at = {}
    for rid in store.rids():
        ck = store.get(rid)
        if ck and rid in steps and 0 < ck["step"] < steps[rid] \
                and ck["step"] % LAUNCHER_STREAM == 0:
            resume_at[rid] = ck["step"]
    del store
    log(f"serve[crash]: recover: clean {rec.clean}, torn {rec.torn}, {rec.events} "
        f"events, pending {sorted(rec.pending)}, finished {sorted(rec.finished)}, "
        f"checkpoints strictly inside their runs {resume_at}")
    restart = run_launcher("crash restart", LAUNCHER_ARGV + [
        "--requests", "0", "--journal", d, "--resume"])
    s = restart["summary"]
    rc = s["counters"]
    after = journal_lib.recover(d)
    log(f"serve[crash restart]: restart wall {restart['wall']:.3f}s (in process: "
        f"the scan, the model's init and the recovered requests); summary "
        f"recovered {s['recovered']}, resumed_from_step {s['resumed_from_step']}, "
        f"completed {s['completed']}; counters {rc}; {CARD}")
    exact, worst = True, 0.0
    for rid, r in sorted(restart["done"].items()):
        want = launcher_done[rid]
        members = batch_of(restart, rid, r.latents)
        base_members = sorted(i for i, x in launcher_done.items()
                              if x.batch_index == want.batch_index)
        err = rel_l2(r.latents, want.latents)
        if members == base_members:
            exact &= bool(np.array_equal(r.latents, want.latents))
        else:
            worst = max(worst, err)
        log(f"serve[crash restart]: request {rid} from step {resume_at.get(rid, 0)} "
            f"of {steps.get(rid)}: latency {r.latency_s:.3f}s, batch {members} "
            f"against serve[launcher]'s {base_members}: bit-equal "
            f"{np.array_equal(r.latents, want.latents)}, relative L2 {err:.3e}; {CARD}")
    launches_ok, out = bool(restart["attempts"]), {}
    for _, rids, launched in restart["attempts"]:
        first = min(rids)
        left = steps[first] - resume_at.get(first, 0)
        want = {"fused_reuse": 2 * LAUNCHER_LAYERS * left,
                "ripple_attention": LAUNCHER_LAYERS * left}
        launches_ok &= launched == want and all(
            resume_at.get(i, 0) == resume_at.get(first, 0) for i in rids)
        for k, v in launched.items():
            out[k] = out.get(k, 0) + v
        log(f"serve[crash restart]: attempt for {rids} from step "
            f"{resume_at.get(first, 0)}: launches {launched}, want {want}")
    checks = {
        "journaled run: every request completed, bit-equal to serve[launcher]":
            sorted(on["done"]) == list(range(6)) and same,
        "journaled run: no degradation, retry, quarantine or watchdog trip":
            quiet_counters(on["summary"]),
        "the crashed launcher died by SIGKILL": proc.returncode == -9,
        "recover: not clean, requests pending, a checkpoint inside its run":
            not rec.clean and bool(rec.pending) and bool(resume_at),
        "restart: recovered = pending, every recovered request completed":
            s["recovered"] == len(rec.pending)
            and sorted(s["completed"]) == sorted(rec.pending) and not s["errors"],
        "restart: resumed_from_step > 0, checkpoint_writes > 0, resumed_count >= 1":
            s["resumed_from_step"] > 0 and rc["checkpoint_writes"] > 0
            and rc["resumed_count"] >= 1,
        "restart: no degradation, retry, quarantine or watchdog trip":
            quiet_counters(s),
        "after the restart: CLEAN marker, recover clean with nothing pending":
            os.path.exists(os.path.join(d, journal_lib.CLEAN_MARKER))
            and after.clean and not after.pending,
        "latents bit-equal to serve[launcher]'s where the batch matches, else "
        "within relative L2 1e-3": exact and worst < 1e-3,
        "each attempt launches fused_reuse and ripple for the steps left only":
            launches_ok,
    }
    report("crash", checks)
    shutil.rmtree(JOURNAL_ROOT, ignore_errors=True)
    return out


RESUME_EVERY = 3  # serve[resume]: boundaries 3, 6, 9 are cache hit steps at R 4


def serve_resume():
    """Mid-flight resume in process, on the launcher's factory over its
    8-layer vDiT (every leaf drawn, none zeroed, so the latents depend on
    every layer's attention).  (a) One request of the (8, 16, 16) bucket,
    12 steps, ``reuse_every`` 4, streamed every 3 steps through a
    journaled engine: the journal directory is copied right after its
    first checkpoint lands (step 3, a cache hit step); a fresh engine on
    the copy resumes it from the journal and the checkpoint and must
    give the uninterrupted run's latents bit for bit, its cache counters,
    and launch fused_reuse only on the refresh steps left (4, 8, 11) and
    ripple on the 9 steps left.  (b) Two replicas behind a router share
    one store; once a checkpoint of the request in flight lands, the
    replica serving it is failed: the survivor resumes it
    (``router_resumed`` >= 1, ``router_resumed_from_step`` > 0) and its
    result equals the request's fault-free run bit for bit (one request:
    the same members)."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch.workloads import mixed_gen_shapes, mixed_request_stream
    from repro_torch.models.params import init_vdit
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving import journal as journal_lib
    from repro_torch.serving.engine import DiffusionEngine
    from repro_torch.serving.router import Router

    arch = apply_overrides(get_config("vdit-paper"), CONTROL_CUT)
    shapes = mixed_gen_shapes(arch, base=serve_lib.serving_shape(
        arch, "gen_512", smoke=False, steps=12))
    model = init_vdit(arch.model, seed=0, device="cuda", zero_init=False)
    factory, _ = serve_lib.make_sampler_factory(arch, shapes, model, device="cuda",
                                                sentinel=True)
    m = arch.model
    grid = m.grid(img_res=shapes[1].img_res)
    n_grid = grid[0] * grid[1] * grid[2]
    hd = m.d_model // m.num_heads
    # q_idx and k_idx: int32 (layers, 1, heads, grid tokens, head dim); the
    # other leaves are (layers, 1, heads) and x is small.
    predicted = 2 * LAUNCHER_LAYERS * m.num_heads * n_grid * hd * 4
    log(f"serve[resume]: vdit-paper full width, {LAUNCHER_LAYERS} layers, grid {grid}, "
        f"12 steps, reuse_every 4, stream every {RESUME_EVERY}; a checkpoint's q_idx + "
        f"k_idx reckoned before the run: {predicted} bytes ({predicted / 1e9:.3f} GB) "
        f"a request")
    reqs = [req for _, req in mixed_request_stream(
        arch, shapes, 2, seed=0, policy="ripple", reuse_every=4,
        stream_every=RESUME_EVERY)]
    req = reqs[1]  # the (8, 16, 16) bucket
    aux = []

    def verdict(orig):
        def f(self, lat, a):
            aux.append({k: int(v) for k, v in (a or {}).items()
                        if k.startswith("cache_")})
            return orig(self, lat, a)
        return f

    def serve(eng, r):
        eng.submit(r)
        eng.start()
        try:
            return eng.result(r.request_id)
        finally:
            eng.stop()

    live, snap = journal_dir("resume-live"), journal_dir("resume-copy")
    journal = journal_lib.Journal(live)
    store = journal_lib.CheckpointStore(live)
    put = store.put

    def put_then_copy(rid, **kw):
        put(rid, **kw)
        if not os.path.exists(snap):
            shutil.copytree(live, snap)

    store.put = put_then_copy
    with wrapped(engine_lib.DiffusionEngine, "_sentinel_verdict", verdict):
        torch.cuda.synchronize()
        reset_launch_counts()
        whole = serve(DiffusionEngine(factory, device="cuda", guardrail=True,
                                      journal=journal, checkpoint_store=store), req)
        torch.cuda.synchronize()
        whole_launches = {k: v for k, v in launch_counts().items() if v}
        sm = store.metrics()
        journal.close()
        rec = journal_lib.recover(snap)
        journal2 = journal_lib.Journal(snap)
        store2 = journal_lib.CheckpointStore(snap)
        ck = store2.get(req.request_id)
        again = journal_lib.request_from_dict(rec.pending[req.request_id])
        again.recovered = True
        again.resume = {"step": ck["step"], "x": ck["x"], "dstate": ck["dstate"]}
        eng = DiffusionEngine(factory, device="cuda", guardrail=True,
                              journal=journal2, checkpoint_store=store2)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        resumed = serve(eng, again)
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        resumed_launches = {k: v for k, v in launch_counts().items() if v}
        em = eng.metrics()
        journal2.close()
    after = journal_lib.recover(snap)
    per_write = sm["checkpoint_bytes"] / max(sm["checkpoint_writes"], 1)
    log(f"serve[resume]: uninterrupted run {whole.latency_s:.3f}s, checkpoints "
        f"{sm['checkpoint_writes']} at steps 3, 6, 9: {per_write:.0f} bytes a write "
        f"(reckoned {predicted} for q_idx + k_idx), checkpoint_write_ms "
        f"{sm['checkpoint_write_ms']:.3f} ({sm['checkpoint_write_ms'] / max(sm['checkpoint_writes'], 1):.3f} "
        f"a write); {CARD}")
    log(f"serve[resume]: resumed from step {ck['step']} (recover: clean {rec.clean}, "
        f"pending {sorted(rec.pending)}) in {resume_wall:.3f}s, latency "
        f"{resumed.latency_s:.3f}s; cache counters {aux[-1]} against {aux[0]}; "
        f"launches {resumed_launches} against {whole_launches} uninterrupted; "
        f"engine counters {em}; {CARD}")
    L = LAUNCHER_LAYERS
    checks = {
        "(a) the copy holds the step-3 checkpoint, a cache hit step":
            not rec.clean and ck is not None and ck["step"] == 3
            and ck["step"] % 4 != 0 and ck["dstate"] is not None,
        "(a) a checkpoint's bytes as reckoned (q_idx + k_idx + at most 8 MB)":
            predicted <= per_write <= predicted + 8e6,
        "(a) resumed latents bit-equal to the uninterrupted run's":
            np.array_equal(resumed.latents, whole.latents),
        "(a) cache hit and refresh counters equal the uninterrupted run's":
            len(aux) == 2 and aux[0] == aux[1] and aux[0].get("cache_hits", 0) > 0,
        "(a) fused_reuse on the refresh steps left, ripple on the steps left":
            whole_launches == {"fused_reuse": 2 * L * 4, "ripple_attention": 12 * L}
            and resumed_launches == {"fused_reuse": 2 * L * 3,
                                     "ripple_attention": 9 * L},
        "(a) resumed_count 1 from step 3, recovered 1; the copy then clean":
            (em["resumed_count"], em["last_resume_step"], em["recovered_count"])
            == (1, 3, 1) and after.clean and not after.pending,
    }
    # (b) checkpointed failover.
    plain = dataclasses.replace(req, request_id=10, reuse_every=None,
                                stream_every=LAUNCHER_STREAM)
    ref = serve(DiffusionEngine(factory, device="cuda", guardrail=True), plain)
    d = journal_dir("failover")
    journal = journal_lib.Journal(d)
    store = journal_lib.CheckpointStore(d)
    router = Router([DiffusionEngine(factory, device="cuda", guardrail=True,
                                     journal=journal, checkpoint_store=store)
                     for _ in range(2)], checkpoint_store=store)
    router.start()
    try:
        idx = router.submit(plain)
        t0 = time.time()
        while plain.request_id not in store.rids() and time.time() < t0 + 120:
            time.sleep(0.01)
        router.fail_replica(idx)
        got = router.result(plain.request_id)
        rm = router.metrics()
    finally:
        router.stop()
        journal.close()
    log(f"serve[resume failover]: replica {idx} failed once its checkpoint landed; "
        f"router_resumed {rm['router_resumed']} from step "
        f"{rm['router_resumed_from_step']}, router_requeued {rm['router_requeued']}; "
        f"survivor latency {got.latency_s:.3f}s (from its resubmit, beside the "
        f"zombie batch), fault-free {ref.latency_s:.3f}s; bit-equal "
        f"{np.array_equal(got.latents, ref.latents)}; {CARD}")
    checks["(b) router_resumed >= 1 from a step > 0"] = (
        rm["router_resumed"] >= 1 and rm["router_resumed_from_step"] > 0)
    checks["(b) the survivor's result bit-equal to the fault-free run"] = \
        np.array_equal(got.latents, ref.latents)
    report("resume", checks)
    shutil.rmtree(JOURNAL_ROOT, ignore_errors=True)
    del model, factory
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The dispatch mesh (slice 15): the sparse kernel's carry, ring attention,
# batch/head sharding through the launcher
# ---------------------------------------------------------------------------

RING_GRID = (8, 32, 32)           # the vDiT's served grid, no text prefix
RING_QKV = (1, 24, 8 * 32 * 32, 128)
RING_STEP = (10, 12)              # step 10 of 12 snaps at θ = 0.2, as served


@contextlib.contextmanager
def forced_devices(n):
    """``REPRO_TORCH_FORCE_DEVICE_COUNT=n`` for the duration (n mesh
    shards on the first card; None: the cards as they are)."""
    from repro_torch.launch.mesh import FORCE_DEVICE_COUNT_ENV

    old = os.environ.pop(FORCE_DEVICE_COUNT_ENV, None)
    if n is not None:
        os.environ[FORCE_DEVICE_COUNT_ENV] = str(n)
    try:
        yield
    finally:
        os.environ.pop(FORCE_DEVICE_COUNT_ENV, None)
        if old is not None:
            os.environ[FORCE_DEVICE_COUNT_ENV] = old


def verdicts(label, checks):
    """One ``ok`` / ``FAIL`` line a check; any failure fails the run."""
    for what, ok in checks.items():
        log(f"{label}: {what}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit(f"{label} failed")


def mixed_svg_call(dtype, seeds):
    """Operands at the ring's shape and an SVG map with both kinds of
    head: the first 12 spatial (FULL and SKIP tiles), the other 12
    temporal (PARTIAL tiles), with its -inf bias; query row 5 of head 0
    keeps no key at all (its output must be zeros, never NaN)."""
    import torch
    from repro_torch.core.svg_mask import spatial_mask, temporal_mask
    from repro_torch.kernels.sparse.ops import block_map_from_keep

    B, H, N, _ = RING_QKV
    keep = torch.empty((B, H, N, N), dtype=torch.bool, device="cuda")
    keep[:, :H // 2] = torch.from_numpy(spatial_mask(RING_GRID)).cuda()
    keep[:, H // 2:] = torch.from_numpy(temporal_mask(RING_GRID)).cuda()
    keep[0, 0, 5] = False
    bmap = block_map_from_keep(keep, 128, 128)
    bias = torch.where(keep, 0.0, float("-inf")).float()
    del keep
    q, k, v = (correlated(RING_QKV, dtype, s) for s in seeds)
    return q, k, v, bias, bmap


def hop_pieces(k, v, bias, bmap, blk, hops):
    """Each hop's contiguous key slice, value slice, bias and map columns
    for a chain of ``hops`` calls over whole key tiles."""
    per = k.shape[2] // hops
    if per % blk:
        raise SystemExit(f"{hops} hops of {per} keys are not whole {blk}-key tiles")
    return [(k[:, :, lo:lo + per].contiguous(), v[:, :, lo:lo + per].contiguous(),
             bias[..., lo:lo + per].contiguous(),
             bmap[..., lo // blk:(lo + per) // blk].contiguous())
            for lo in range(0, k.shape[2], per)]


def run_chain(q, pieces, blk):
    from repro_torch.kernels.sparse.ops import sparse_attention

    state = out = None
    for kh, vh, bh, mh in pieces:
        out, state = sparse_attention(q, kh, vh, bias=bh, block_map=mh, block_q=blk,
                                      block_k=blk, carry=state, return_state=True)
    return out, state


def sparse_carry_phase():
    """``sparse[carry]``: the carry of both kernel paths, bf16 on the
    tensor cores and f32 on the CUDA cores, at (1, 24, 8192, 128) (the
    vDiT's grid without text; f32 is kernel_bench's wide shape) on a map
    with FULL, PARTIAL and SKIP tiles: chains of 2, 4 and 8 hops over
    whole key tiles equal one call bit for bit (output and state), the
    output and the state's acc / l held to the oracle at the kernel's bar
    and m to the plain version's, a fully masked row gives zeros, and an
    all-SKIP hop, elided as the ring elides it, launches nothing.  Times a
    chain of 4 against one call by device time, SDPA with the same f32
    mask beside.  Returns the bf16 times."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.sparse import ops as sparse_ops
    from repro_torch.kernels.sparse.ref import SKIP, finalize, sparse_attention_ref

    out_times = {}
    for dt, seeds in ((torch.bfloat16, (51, 52, 53)), (torch.float32, (54, 55, 56))):
        name = str(dt).replace("torch.", "")
        q, k, v, bias, bmap = mixed_svg_call(dt, seeds)
        blk = 128
        kw = dict(bias=bias, block_map=bmap, block_q=blk, block_k=blk)
        one = sparse_ops.sparse_attention(q, k, v, **kw)
        one_s, state1 = sparse_ops.sparse_attention(q, k, v, return_state=True, **kw)
        checks = {"an output with the state equals one without, bit for bit":
                  torch.equal(one, one_s)}
        for hops in (2, 4, 8):
            out, state = run_chain(q, hop_pieces(k, v, bias, bmap, blk, hops), blk)
            checks[f"{hops} hops equal one call bit for bit (out, m, l, acc)"] = (
                torch.equal(out, one) and all(torch.equal(a, b)
                                              for a, b in zip(state, state1)))
        m, l, acc = state1
        checks["a fully masked row: zeros, l 0, everything finite"] = (
            bool((one[0, 0, 5] == 0).all()) and float(l[0, 0, 5]) == 0.0
            and bool(torch.isfinite(one.float()).all()))
        ref = sparse_oracle(q, k, v, bias, bmap, blk, round_p=dt == torch.bfloat16,
                            exact=dt == torch.float32)
        slack = f32_logit_slack(q, k, v) if dt == torch.float32 else 0.0
        tol = attn_tol(name, ref) + slack
        err = (one.to(ref.dtype) - ref).abs().max().item()
        err_state = (finalize(acc, l, torch.float32).to(ref.dtype) - ref).abs().max().item()
        plain_out, (pm, pl, pacc) = sparse_attention_ref(
            q, k, v, scale=float(1.0 / 128 ** 0.5), return_state=True, **kw)
        # m is the row's largest scaled logit: the plain version rounds the
        # bf16 product to bf16 before scaling (half an ulp, at most 2^-8 of
        # it), the kernel keeps it in f32; 2^-7 leaves room for the f32
        # sums.  A row with no live key keeps the fresh -1e30 on both.
        live = pl > 0
        m_tol = (2.0 ** -7 if dt == torch.bfloat16 else 1e-6) * pm[live].abs().max().item()
        err_m = (m - pm)[live].abs().max().item()
        checks["m of the fully masked row is the fresh -1e30 on both"] = (
            float(m[0, 0, 5]) == float(pm[0, 0, 5]) == torch.tensor(-1e30).item())
        err_plain = (plain_out.to(ref.dtype) - ref).abs().max().item()
        checks[f"out within {tol:.3g} of the oracle ({err:.3e})"] = err <= tol
        checks[f"the state's acc / l within {tol:.3g} ({err_state:.3e})"] = err_state <= tol
        checks[f"m within {m_tol:.3g} of the plain version's ({err_m:.3e})"] = err_m <= m_tol
        # Two implementations each within tol of the oracle: the kernel is
        # held to its plain version at twice that.
        err_kp = (one.float() - plain_out.float()).abs().max().item()
        checks[f"the plain version within {tol:.3g} of the oracle ({err_plain:.3e})"] = \
            err_plain <= tol
        checks[f"the kernel within {2 * tol:.3g} of its plain version ({err_kp:.3e})"] = \
            err_kp <= 2 * tol
        del ref, plain_out, pm, pl, pacc
        # The ring's elision: the query rows of frame 2 on the spatial heads,
        # their keys chained a frame a hop.  Their map keeps frames 0 and 2
        # only, so the other hops are all-SKIP and are not called, and the
        # chain still equals one call on those rows.
        T, nf, hs = RING_GRID[0], RING_GRID[1] * RING_GRID[2], RING_QKV[1] // 2
        qr = q[:, :hs, 2 * nf:3 * nf].contiguous()
        br = bias[:, :hs, 2 * nf:3 * nf]
        mr = bmap[:, :hs, 2 * nf // blk:3 * nf // blk]
        kh, vh = k[:, :hs].contiguous(), v[:, :hs].contiguous()
        pieces = hop_pieces(kh, vh, br, mr, blk, T)
        skip_hop = [i for i, p in enumerate(pieces) if bool((p[3] == SKIP).all())]
        torch.cuda.synchronize()
        reset_launch_counts()
        out_e, _ = run_chain(qr, [p for i, p in enumerate(pieces) if i not in skip_hop],
                             blk)
        torch.cuda.synchronize()
        n_launch = launch_counts()["sparse_attention"]
        whole = sparse_ops.sparse_attention(qr, kh, vh, bias=br, block_map=mr,
                                            block_q=blk, block_k=blk)
        checks[f"all-SKIP hops {skip_hop} of {T} launch nothing ({n_launch} launches), "
               f"and the chain equals one call bit for bit"] = (
            skip_hop == [h for h in range(T) if h not in (0, 2)]
            and n_launch == T - len(skip_hop) and torch.equal(out_e, whole))
        del qr, br, mr, kh, vh, pieces, out_e, whole
        path = "tensor cores" if sparse_ops.uses_tensor_cores(q, v) else "CUDA cores"
        checks[f"path: {path}"] = (path == "tensor cores") == (dt == torch.bfloat16)
        pieces4 = hop_pieces(k, v, bias, bmap, blk, 4)
        one_ms, _ = device_time_ms(lambda: sparse_ops.sparse_attention(q, k, v, **kw),
                                   "sparse_", iters=10)
        chain_ms, _ = device_time_ms(lambda: run_chain(q, pieces4, blk), "sparse_",
                                     iters=10, per_call=4)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=bias,
                                           scale=float(1.0 / 128 ** 0.5)), iters=3)
        bound, by, _, _ = sparse_bound(q, v, bias, bmap, blk)
        log(f"time sparse[carry] {name} {RING_QKV} ({tile_shares(bmap)}; {path}): one "
            f"call {one_ms:.4f} ms, a chain of 4 hops with the carry {chain_ms:.4f} ms "
            f"({chain_ms / one_ms:.3f}x: the carry's cost), sdpa with the f32 mask "
            f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); device times; {CARD}")
        verdicts(f"sparse[carry] {name}", checks)
        out_times[name] = {"one_ms": one_ms, "chain4_ms": chain_ms, "sdpa_ms": lib_ms,
                           "bound_ms": bound, "max_abs_err": err}
        del q, k, v, bias, bmap, one, one_s, state1, pieces4, live, kw
        torch.cuda.empty_cache()
    return out_times


def expected_elided(bmap, shards):
    """Ring hops whose block-map slice is all-SKIP, counted on the
    unsharded map: shard ``me``'s rows against shard ``src``'s keys, in
    every batch row and head."""
    from repro_torch.kernels.sparse.ref import SKIP

    t = bmap.shape[-1] // shards
    skip = bmap == SKIP
    return sum(bool(skip[..., me * t:(me + 1) * t, src * t:(src + 1) * t].all())
               for me in range(shards) for src in range(shards))


def ring_dispatch(label, q, k, v, cfg, policy, backend, mesh):
    """One cached ``attention_dispatch`` call (a refresh step) under
    ``mesh`` (None: unsharded), with the launch counters set to 0 just
    before and read just after, and the peak memory."""
    import torch
    from repro_torch.core import dispatch as dispatch_lib
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with dispatch_lib.dispatch_mesh(mesh):
        plan = dispatch_lib.resolve_plan(q.shape, v.shape, cfg, on_cuda=True,
                                         backend=backend, policy=policy, grid=RING_GRID)
        out, state = dispatch_lib.attention_dispatch(
            q, k, v, grid=RING_GRID, cfg=cfg, step=RING_STEP[0],
            total_steps=RING_STEP[1], policy=policy, backend=backend,
            return_decision=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: c for n, c in launch_counts().items() if c}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"ring[{label}]: {plan.summary()}: {wall * 1e3:.1f} ms, launches {counts}, "
        f"peak {peak:.2f} GiB; {CARD}")
    return out, state, plan, counts


def ring_phase(multi_card=False):
    """``ring[svg]`` and ``ring[ripple]``: ``attention_dispatch`` at the
    vDiT's width on its grid without a text prefix, (1, 24, 8192, 128)
    bf16, unsharded and under ``1x1x2`` and ``1x1x4`` meshes whose
    shards share the one card (``multi_card``: one shard per card).  svg
    within the sparse kernel's bf16 bar of the unsharded call, its
    elided hops equal to the count from the unsharded block map and its
    sparse launches shards x hops - elided; ripple (the reference
    backend, decisions on the halo slab) bit for bit.  Then the port's
    kernel-bench ring section under 8 shards.  Returns the sparse
    launches of the svg ring runs and the kernel-bench row."""
    import torch
    from repro_torch.config.base import RippleConfig
    from repro_torch.core.policy import get_policy
    from repro_torch.launch import kernel_bench
    from repro_torch.launch.mesh import parse_mesh_spec

    bf16 = torch.bfloat16
    q, k, v = (correlated(RING_QKV, bf16, s) for s in (61, 62, 63))
    ring_launches = 0
    for policy, backend in (("svg", None), ("ripple", "reference")):
        cfg = RippleConfig(enabled=True, policy=policy)
        pol = get_policy(policy)
        ref, _, plan0, c0 = ring_dispatch(f"{policy} unsharded", q, k, v, cfg, policy,
                                          backend, None)
        bmap = None
        if policy == "svg":
            d = pol.decide(q, k, grid=RING_GRID, cfg=cfg,
                           thetas=pol.thetas_for(cfg, *RING_STEP), block_shape=(128, 128))
            bmap = d.block_map
            del d
        # One shard a card: the most cards (8, 4 or 2) whose count divides
        # the grid's 8 frames.
        cards = max(n for n in (8, 4, 2, 1) if n <= torch.cuda.device_count())
        ways = ((cards, None),) if multi_card else ((2, 2), (4, 4))
        for shards, forced in ways:
            tag = f"{policy} x{shards}{' one shard a card' if multi_card else ''}"
            with forced_devices(forced):
                mesh = parse_mesh_spec(f"1x1x{shards}")
            out, state, plan, counts = ring_dispatch(tag, q, k, v, cfg, policy, backend,
                                                     mesh)
            checks = {f"plan rings {shards} ways": plan.seq_shards == shards}
            if policy == "svg":
                tol = attn_tol("bfloat16", ref.float())
                err = (out.float() - ref.float()).abs().max().item()
                elided = int(state.elided.sum())
                want = expected_elided(bmap, shards)
                sparse = counts.get("sparse_attention", 0)
                ring_launches += sparse
                checks[f"within {tol:.3g} of the unsharded call ({err:.3e})"] = err <= tol
                checks[f"elided hops {elided} = {want} from the unsharded block map"] = \
                    elided == want
                checks[f"sparse launches {sparse} = {shards} x {shards} hops - "
                       f"{elided} elided"] = sparse == shards * shards - elided
            else:
                checks["bit for bit the unsharded call"] = torch.equal(out, ref)
                checks["the reference backend launches no attention kernel"] = \
                    "ripple_attention" not in counts
            checks["finite"] = bool(torch.isfinite(out.float()).all())
            verdicts(f"ring[{tag}]", checks)
            del out, state
        del ref, bmap
        torch.cuda.empty_cache()
    del q, k, v
    torch.cuda.empty_cache()
    if multi_card:
        return ring_launches, None
    with forced_devices(8):
        r = kernel_bench.ring_sweep(device="cuda")
    if r is None or not r["ring"] or r["elided_hops"] <= 0:
        raise SystemExit(f"kernel_bench ring section: {r}")
    log(f"{kernel_bench.ring_row(r)} (8 shards on one card; {CARD})")
    return ring_launches, r


def mesh_phases():
    """The kernel-level phases of the mesh: ``sparse[carry]``, then
    ``ring[svg]`` / ``ring[ripple]`` on shards of the one card and the
    kernel-bench ring section, then, with more than one card, ``ring[svg]``
    again with one shard a card."""
    import torch

    carry = sparse_carry_phase()
    ring_launches, bench = ring_phase()
    if torch.cuda.device_count() > 1:
        ring_phase(multi_card=True)
    else:
        log("ring[svg] with one shard a card: not run (1 card visible)")
    return carry, ring_launches, bench


def serve_mesh(launcher_done):
    """``serve[mesh]``: the launcher's ``main`` with ``serve[launcher]``'s
    argv, one request more (7: bucket 0 then runs a batch of 2 and one of
    1) and ``--mesh 2x2`` on 4 shards of the one card, with the launch
    counters set to 0 just before and read just after.  Requests 0-5
    equal ``serve[launcher]``'s bit for bit; request 6 equals its batch
    run again in one piece without the mesh; each bucket's plan line
    reads ``shard=batch2xheads2`` at batch 2 and ``shard=batch1xheads2``
    (the replicated batch axis) at batch 1; fused_reuse and ripple
    launch once a shard where one run launches them once (4x); the quiet
    counters stay 0.  Returns the launch counts and the results by
    request id."""
    import json
    import tempfile

    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as serve_lib
    from repro_torch.serving import engine as engine_lib

    seen, plans = {}, []

    def keeping(name):
        def make(orig):
            def f(*a, **kw):
                seen[name] = out = orig(*a, **kw)
                return out
            return f
        return make

    def plan_lines(orig):
        def f(arch, sp, **kw):
            out = orig(arch, sp, **kw)
            plans.append((sp.name, kw.get("batch", 1), serve_lib.plans_summary(out)))
            return out
        return f

    argv = list(MESH_ARGV)
    log(f"serve[mesh]: python -m repro_torch.launch.serve {' '.join(argv)} "
        f"(REPRO_TORCH_FORCE_DEVICE_COUNT=4: 4 shards on the one card)")
    with tempfile.TemporaryDirectory() as tmp, forced_devices(4):
        path = os.path.join(tmp, "summary.json")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with wrapped(serve_lib, "make_sampler_factory", keeping("factory")), \
                wrapped(serve_lib, "mixed_request_stream", keeping("traffic")), \
                wrapped(serve_lib, "attention_plans", plan_lines), \
                plain_guard(vdit_plain_versions()) as plain:
            done = serve_lib.main(argv + ["--summary-json", path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with open(path, encoding="utf-8") as f:
            summary = json.load(f)
    done = {r.request_id: r for r in done}
    # Request 6's batch again, in one piece, without the mesh (main has
    # restored the previous, absent one).
    factory = seen["factory"][0]
    req = {r.request_id: r for _, r in seen["traffic"]}[6]
    fn = factory(req.latent_shape, req.steps, req.policy, req.reuse_every, None)
    noise = engine_lib.request_noise(req.seed, req.latent_shape, "cuda")[None]
    txt = torch.from_numpy(np.asarray(req.txt)[None]).float().cuda()
    out = fn(noise, txt, [req.seed])
    alone = (out[0] if isinstance(out, tuple) else out).float().cpu().numpy()[0]
    del factory, fn, seen
    steps = {0: 12, 1: 12, 2: 6}
    batches = {}
    for rid, r in done.items():
        batches[r.batch_index] = steps[rid % 3]
        base = launcher_done.get(rid)
        log(f"serve[mesh]: request {rid} latency {r.latency_s:.3f}s (serve[launcher] "
            f"{'-' if base is None else f'{base.latency_s:.3f}s'}), ttff "
            f"{r.ttff_s:.3f}s, batch {r.batch_index} served in {r.walltime_s:.3f}s; {CARD}")
    layer_steps = LAUNCHER_LAYERS * sum(batches.values())
    shards = 4
    for name, batch, line in plans:
        log(f"serve[mesh]: plan of {name} at batch {batch}: {line}")
    checks = {
        "all 7 requests completed": sorted(done) == list(range(7))
        and not summary["errors"],
        "requests 0-5 equal serve[launcher]'s bit for bit": all(
            np.array_equal(done[i].latents, launcher_done[i].latents) for i in range(6)),
        "request 6 (a batch of 1) equals its run without the mesh bit for bit":
            np.array_equal(done[6].latents, alone),
        "plan lines: shard=batch2xheads2 at batch 2, shard=batch1xheads2 at batch 1":
            bool(plans) and all(
                ("shard=batch2xheads2" in line) if b % 2 == 0 else
                ("shard=batch1xheads2" in line) for _, b, line in plans),
        "a batch of 2 and a batch of 1 both planned":
            {b for _, b, _ in plans} >= {1, 2},
        f"fused_reuse twice and ripple once a layer-step on each of {shards} shards":
            counts["fused_reuse"] == shards * 2 * layer_steps
            and counts["ripple_attention"] == shards * layer_steps,
        "no degradation, retry, quarantine or watchdog trip": quiet_counters(summary),
        "no plain version ran on the card": not any(plain.values()),
    }
    log(f"serve[mesh]: launches {counts}; {wall:.1f}s with the model's init; {CARD}")
    report("mesh", checks)
    torch.cuda.empty_cache()
    return counts, done


# serve[mesh]'s argv: serve[launcher]'s with a seventh request (bucket 0
# then runs a batch of 2 and one of 1) and --mesh 2x2.
MESH_ARGV = [("7" if a == "6" and LAUNCHER_ARGV[i - 1] == "--requests" else a)
             for i, a in enumerate(LAUNCHER_ARGV)] + ["--mesh", "2x2"]
MESH_RANKS = 2   # dist[serve mesh]: gloo ranks on the one card, 2 shards each


def serve_mesh_worker(out, rank, port):
    """``chip_smoke.py --serve-mesh-worker OUT RANK PORT``, one rank of
    ``dist[serve mesh]``: joins a gloo group of ``MESH_RANKS`` at a local
    port itself (the launcher's ``init_distributed`` then finds it and
    returns False), makes 2 mesh shards visible on the card and runs the
    launcher's ``main`` with ``serve[mesh]``'s argv under
    ``--distributed``, the launch counters set to 0 just before and read
    just after; writes its latents to OUT.npz and its launches,
    latencies, peak memory, plain-version calls, the host wall of its
    cross-rank all-gathers (``spmd.all_gather_ranks``: the copies to and
    from pinned memory and gloo's transfer, waiting for the peer
    included) and summary to OUT.json."""
    import json
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import spmd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as serve_lib

    exchange = {"calls": 0, "s": 0.0, "bytes": 0}

    def timing(orig):
        def f(pg, t, device):
            t0 = time.perf_counter()
            out = orig(pg, t, device)
            exchange["calls"] += 1
            exchange["s"] += time.perf_counter() - t0
            exchange["bytes"] += t.numel() * t.element_size()
            return out
        return f

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=MESH_RANKS, rank=int(rank),
                            timeout=timedelta(seconds=300))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with forced_devices(2), plain_guard(vdit_plain_versions()) as plain, \
            wrapped(spmd, "all_gather_ranks", timing):
        done = serve_lib.main(MESH_ARGV + ["--distributed", "--summary-json",
                                           out + ".summary.json"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    np.savez(out + ".npz", **{str(r.request_id): r.latents for r in done})
    with open(out + ".summary.json", encoding="utf-8") as f:
        summary = json.load(f)
    with open(out + ".json", "w", encoding="utf-8") as f:
        json.dump({"launches": counts, "wall_s": wall, "plain": plain,
                   "exchange": exchange,
                   "backend": dist.get_backend(), "ranks": dist.get_world_size(),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "latency": {str(r.request_id): r.latency_s for r in done},
                   "ttff": {str(r.request_id): r.ttff_s for r in done},
                   "summary": summary}, f, indent=1)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dist_serve_mesh(mesh_done, counts_mesh):
    """``dist[serve mesh]``: ``MESH_RANKS`` processes on the one card, each
    a rank of a gloo group (:func:`serve_mesh_worker`), serve
    ``serve[mesh]``'s 7 requests with ``--mesh 2x2`` spanning the ranks
    (data across ranks, model within one; CUDA tensors cross through
    pinned host memory, as gloo needs).  Each rank's completions equal
    ``serve[mesh]``'s bit for bit, the ranks' fused_reuse and ripple
    launches sum to its, the completion digests agree, and no plain
    version ran on the card; each request's latency beside
    ``serve[mesh]``'s, each rank's peak memory.  NCCL between ranks
    needs a card a rank: not measured here."""
    import json
    import socket

    import numpy as np
    import torch

    os.makedirs(DIST_DIR, exist_ok=True)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    outs = [os.path.join(DIST_DIR, f"serve-mesh-{r}") for r in range(MESH_RANKS)]
    # The card's host threads split between the ranks.
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS=str(max(1, torch.get_num_threads() // MESH_RANKS)))
    log(f"dist[serve mesh]: {MESH_RANKS} x chip_smoke.py --serve-mesh-worker: "
        f"python -m repro_torch.launch.serve {' '.join(MESH_ARGV)} --distributed, "
        f"a gloo group of {MESH_RANKS} ranks, REPRO_TORCH_FORCE_DEVICE_COUNT=2 each")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--serve-mesh-worker", outs[r], str(r), str(port)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MESH_RANKS)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, texts)):
        lines = text.strip().splitlines()
        for ln in lines:
            if "dispatch mesh" in ln or "completions equal" in ln or "process " in ln:
                log(f"dist[serve mesh]: rank {r} | {ln.strip()}")
        if p.returncode != 0:
            for ln in lines[-40:]:
                log(f"dist[serve mesh]: rank {r} | {ln}")
            raise SystemExit(f"dist[serve mesh]: rank {r} exit {p.returncode}")
    got = []
    for o in outs:
        with open(o + ".json", encoding="utf-8") as f:
            rec = json.load(f)
        rec["latents"] = dict(np.load(o + ".npz"))
        got.append(rec)
    for rid in sorted(mesh_done):
        lat = ", ".join(f"rank {r} {g['latency'][str(rid)]:.3f}s" for r, g in enumerate(got))
        log(f"dist[serve mesh]: request {rid} latency {lat} (serve[mesh] "
            f"{mesh_done[rid].latency_s:.3f}s); {CARD}")
    for r, g in enumerate(got):
        log(f"dist[serve mesh]: rank {r}: launches fused_reuse "
            f"{g['launches']['fused_reuse']}, ripple_attention "
            f"{g['launches']['ripple_attention']}; peak {g['peak_gib']:.2f} GiB; "
            f"{g['wall_s']:.1f}s in main with the model's init, of which "
            f"{g['exchange']['s']:.1f}s in {g['exchange']['calls']} cross-rank "
            f"all-gathers sending {g['exchange']['bytes'] / 1e9:.2f} GB; {CARD}")
    log(f"dist[serve mesh]: {wall:.1f}s with the processes' start; serve[mesh] "
        f"launches fused_reuse {counts_mesh['fused_reuse']}, ripple_attention "
        f"{counts_mesh['ripple_attention']}; NCCL between ranks: not measured "
        f"(one card cannot host two NCCL ranks)")
    checks = {
        f"a gloo group of {MESH_RANKS} ranks": all(
            g["backend"] == "gloo" and g["ranks"] == MESH_RANKS for g in got),
        "every rank completed all 7 requests": all(
            sorted(g["summary"]["completed"]) == list(range(7))
            and not g["summary"]["errors"] for g in got),
        "every rank's completions equal serve[mesh]'s bit for bit": all(
            sorted(g["latents"], key=int) == [str(i) for i in sorted(mesh_done)]
            and all(np.array_equal(g["latents"][str(i)], mesh_done[i].latents)
                    for i in mesh_done) for g in got),
        "the completion digests agree over the ranks": all(
            g["summary"].get("completion_digests") == got[0]["summary"]
            .get("completion_digests") for g in got)
        and len(got[0]["summary"].get("completion_digests", {})) == 7,
        "the ranks' fused_reuse and ripple launches sum to serve[mesh]'s": all(
            sum(g["launches"][k] for g in got) == counts_mesh[k]
            for k in ("fused_reuse", "ripple_attention")),
        "each rank launched half": all(
            g["launches"][k] * MESH_RANKS == counts_mesh[k]
            for g in got for k in ("fused_reuse", "ripple_attention")),
        "no degradation, retry, quarantine or watchdog trip": all(
            quiet_counters(g["summary"]) for g in got),
        "no plain version ran on the card": not any(
            v for g in got for v in g["plain"].values()),
    }
    report("serve mesh", checks, kind="dist")


def dist_serve(launcher_done, counts_la):
    """``dist[serve]``: the launcher's ``main`` with ``serve[launcher]``'s
    argv under ``--distributed`` at one rank (``--coordinator`` a free
    local port, ``--num-processes 1 --process-id 0``): the process joins
    an NCCL group before touching the card, then serves as one process
    does.  Every request equals ``serve[launcher]``'s bit for bit, with
    the same launches; an all-reduce over the group runs on the card.
    The group is destroyed after."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as serve_lib

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    argv = LAUNCHER_ARGV + ["--distributed", "--coordinator", f"127.0.0.1:{port}",
                            "--num-processes", "1", "--process-id", "0"]
    log(f"dist[serve]: python -m repro_torch.launch.serve {' '.join(argv)}")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        done = {r.request_id: r for r in serve_lib.main(argv)}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        backend, world = dist.get_backend(), dist.get_world_size()
        one = torch.ones(4, device="cuda")
        dist.all_reduce(one)
        torch.cuda.synchronize()
        reduced = bool((one == 1).all())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for rid, r in sorted(done.items()):
        log(f"dist[serve]: request {rid} latency {r.latency_s:.3f}s (serve[launcher] "
            f"{launcher_done[rid].latency_s:.3f}s), ttff {r.ttff_s:.3f}s; {CARD}")
    log(f"dist[serve]: backend {backend}, {world} rank(s); launches {counts}; "
        f"{wall:.1f}s with the group's and the model's init; {CARD}")
    checks = {
        "the group is NCCL at one rank and all-reduces on the card":
            backend == "nccl" and world == 1 and reduced,
        "all 6 requests completed": sorted(done) == sorted(launcher_done),
        "every request equals serve[launcher]'s bit for bit": all(
            np.array_equal(done[i].latents, launcher_done[i].latents) for i in done),
        "the same fused_reuse and ripple launches as serve[launcher]": all(
            counts[k] == counts_la[k] for k in ("fused_reuse", "ripple_attention")),
    }
    report("serve", checks, kind="dist")
    return counts


def ripple_ranges():
    """The ripple wrapper's collapse-flag pass (plain PyTorch, on the key
    operand) and the policy's snap step (the fused_reuse kernel and any
    glue around it) as profiler families of their own."""
    from repro_torch.core import policy
    from repro_torch.kernels.ripple import ops as ripple_ops

    return [(ripple_ops, "block_flags", "ripple_flags"),
            (policy, "snap_operand", "snap")]


def profile_forward(label, arch, model, lat_shape, families, annotate=(),
                    batch=SERVE_REQUESTS, total=SERVE_STEPS, step=10, make_state=None,
                    keep_state=None):
    """Device time by kernel family over one served-size denoiser forward
    (``step`` of ``total``, default 10: snapping on), from torch.profiler,
    the device's idle share of that forward's wall time, and its peak
    device memory; returns the wall, busy and family times in ms.  With
    ``make_state`` each forward threads the decision-cache state it
    returns; the profiled forward's final state goes into the list
    ``keep_state``.
    ``families`` maps a family to a kernel-name substring; each
    ``(obj, attr, family)`` of ``annotate`` wraps ``obj.attr`` in a
    profiler range and counts every kernel launched inside it as
    ``family`` (the innermost range wins), a kernel family of
    ``families`` included."""
    import torch

    from repro_torch.launch.serve import model_summary
    from repro_torch.launch.workloads import _denoise_call

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.randn((batch, *lat_shape), generator=g, device="cuda")
    m = arch.model
    if arch.family == "dit":
        cond = {"labels": torch.randint(0, m.num_classes, (batch,), generator=g,
                                        device="cuda")}
    elif arch.family == "unet":
        cond = {"ctx": 0.05 * torch.randn((batch, m.ctx_tokens, m.ctx_dim),
                                          generator=g, device="cuda")}
    else:
        cond = {"txt": 0.05 * torch.randn((batch, m.txt_tokens, m.txt_dim),
                                          generator=g, device="cuda")}
    if arch.family == "mmdit":
        cond["vec"] = torch.zeros((batch, 768), device="cuda")
    # The sampler's time at ``step``: rectified flow's t in [0, 1] for the
    # mmdit's Euler path, a DDPM timestep for the others.
    t = torch.full((batch,), 1.0 - step / total if arch.family == "mmdit" else 200.0,
                   device="cuda")

    def fwd():
        if make_state is None:
            return _denoise_call(arch, model, x, t, cond, step, total)
        out, st = _denoise_call(arch, model, x, t, cond, step, total, dstate=make_state())
        if keep_state is not None:
            keep_state[:] = st
        return out

    return profile_call(label, fwd, families, annotate, keep_state,
                        f"batch {batch}, {model_summary(arch)}, step {step} of {total}")


def profile_call(label, fwd, families, annotate=(), keep_state=None, desc="",
                 what="one forward"):
    """One call of ``fwd`` under torch.profiler, read as
    :func:`profile_forward` says (``what`` and ``desc`` name the call in
    the log): a classifier's forward comes here directly."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

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
    if keep_state is not None:
        keep_state.clear()  # the warm-up's plans go before the profiled forward
    torch.cuda.reset_peak_memory_stats()
    ranges = [fam for *_, fam in annotate]

    def ranged(ann):
        def wrap(orig):
            def f(*a, **kw):
                with record_function(ann):
                    return orig(*a, **kw)
            return f
        return wrap

    with contextlib.ExitStack() as ctx:
        for obj, attr, ann in annotate:
            ctx.enter_context(wrapped(obj, attr, ranged(ann)))
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        ctx.enter_context(prof)
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    fam = {k: 0.0 for k in families}
    fam.update(gemm=0.0, other=0.0)
    spans = []
    kin = prof.profiler.kineto_results.events()
    for e in kin:  # device-side activities only (kernels, copies), in µs
        if e.device_type() != DeviceType.CUDA or e.name() in ranges:
            continue  # (a range's own span on the device timeline)
        spans.append((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3))
        fam[family(e.name())] += e.duration_ns() / 1e3
    by_name = {ann: {} for ann in ranges}
    # A kernel whose launch (the runtime call with its correlation id) lies
    # inside a range's host interval moves to that range's family, the
    # innermost range winning; kernels launched outside any aten op (the
    # ctypes launches of the port's kernels) are found the same way.
    for ann in ranges:
        fam[ann] = 0.0
    spans_h = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in kin if e.device_type() == DeviceType.CPU
                     and e.name() in ranges)
    launch_at = {e.correlation_id(): e.start_ns() for e in kin
                 if e.device_type() == DeviceType.CPU and e.name().startswith("cu")}
    for e in kin:
        if e.device_type() != DeviceType.CUDA or e.name() in ranges:
            continue
        t = launch_at.get(e.correlation_id())
        inner = [r for r in spans_h if t is not None and r[0] <= t <= r[1]]
        if not inner:
            continue
        ann, us = max(inner)[2], e.duration_ns() / 1e3
        fam[family(e.name())] -= us
        fam[ann] += us
        by_name[ann][e.name()[:60]] = by_name[ann].get(e.name()[:60], 0.0) + us
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
    log(f"profile[{label}]: {what}, {desc}: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms (sum of events {sum_ms:.3f} ms; idle "
        f"share {1 - busy_ms / wall_ms:.4f}); {parts}; peak device memory "
        f"{peak:.2f} GiB")
    for ann, kernels in by_name.items():
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        log(f"profile[{label}]: {ann} by kernel: " + "; ".join(
            f"{k} {v / 1e3:.3f} ms" for k, v in top))
    if sum_ms > 1.01 * busy_ms or busy_ms > wall_ms or min(fam.values()) < -1e-3:
        raise SystemExit(f"profile[{label}]: device time exceeds its span or the wall "
                         "time; the reading is not usable")
    for ann in ranges:
        if fam[ann] <= 0:
            raise SystemExit(f"profile[{label}]: no kernel attributed to {ann}")
    return {"wall": wall_ms, "busy": busy_ms, **{k: v / 1e3 for k, v in fam.items()}}


def snap_times(layers):
    """The snap step of the ``repro_torch`` first on ``sys.path``, through
    its public calls only (``fused_compute_reuse``, ``snap_operand``):
    device time a call of the fused_reuse kernel on the vDiT's contiguous
    grid segment (3, 24, 8192, 128) and at dit-xl2's (4, 16, 4096, 72),
    T = 1, axes xy; of the whole snap step (every kernel) at the vDiT's
    served call (3, 24, 8448, 128) with 256 text tokens; and one vDiT
    forward (``layers`` deep, batch 3) profiled without and with the snap
    step as a range of its own.  Prints one ``snap-ab: {...}`` JSON line
    with the times and a digest of the three calls' outputs."""
    import hashlib

    import torch
    from repro_torch.config.base import RippleConfig
    from repro_torch.core import policy
    from repro_torch.kernels import _build
    from repro_torch.kernels.reuse_mask import ops as reuse_ops
    from repro_torch.launch.serve import build_sampler

    info = _build.build_all(["fused_reuse"])["fused_reuse"]
    log(f"snap-ab: built {info['path']}")
    bf16 = torch.bfloat16
    th = dict(zip("txy", (0.2,) * 3))
    vgrid, dgrid = (8, 32, 32), (1, 64, 64)
    gs = (SERVE_TEXT[0], SERVE_SNAP[2])
    xv = reuse_operand(SERVE_SNAP, bf16, 20, 0.6, text=SERVE_TEXT)
    flush = l2_flush()
    digest = hashlib.sha256()
    out = {}

    def hold(snapped, mask):
        digest.update(snapped.view(torch.int16).cpu().numpy().tobytes())
        digest.update(mask.cpu().numpy().tobytes())

    calls = {
        "segment": (xv.narrow(-2, *gs).contiguous(), vgrid, ("t", "x", "y")),
        "dit": (correlated((DIT_REQUESTS, 16, 4096, 72), bf16, 22), dgrid, ("x", "y")),
    }
    for key, (x, grid, axes) in calls.items():
        def call(x=x, grid=grid, axes=axes):
            return reuse_ops.fused_compute_reuse(x, grid, th, axes=axes)
        hold(*call())
        out[key], out[f"{key}_host"] = device_time_ms(call, "fused_reuse_kernel",
                                                      flush=flush)
    del calls
    cfg = RippleConfig(enabled=True)
    args = (xv, True, vgrid, th, cfg, ("t", "x", "y"), gs)
    hold(*policy.snap_operand(*args, use_fused=True))
    out["snap"], out["snap_host"] = device_time_ms(
        lambda: policy.snap_operand(*args, use_fused=True), None, flush=flush)
    del xv, args, flush
    torch.cuda.empty_cache()

    arch, shape, model = load_served_model(layers)
    _, lat_shape = build_sampler(arch, shape, model)
    fams = {"ripple_attention": "ripple", "fused_reuse": "fused_reuse"}
    flat = profile_forward("snap-ab", arch, model, lat_shape, fams,
                           annotate=ripple_ranges()[:1])
    ranged = profile_forward("snap-ab with the snap range", arch, model, lat_shape,
                             fams, annotate=ripple_ranges())
    out.update(wall=flat["wall"], other=flat["other"], fused_reuse=flat["fused_reuse"],
               ripple=flat["ripple_attention"], snap_forward=ranged["snap"],
               other_ranged=ranged["other"], wall_ranged=ranged["wall"],
               digest=digest.hexdigest())
    print("snap-ab: " + json.dumps(out), flush=True)


def snap_ab(baseline, layers):
    """The snap step of the checkout at ``baseline`` (for example the
    parent commit, unpacked by ``git archive``) against this checkout's,
    by :func:`snap_times` in a process of its own for each, in turns:
    baseline, current, current, baseline.  The outputs must agree bit
    for bit.  Returns 0, or exits non-zero."""
    trees = {"baseline": os.path.join(os.path.abspath(baseline), "src"),
             "current": os.path.join(ROOT, "src")}
    if not os.path.isdir(os.path.join(trees["baseline"], "repro_torch")):
        raise SystemExit(f"chip_smoke: no src/repro_torch under {baseline}")
    runs = {}
    for who in ("baseline", "current", "current", "baseline"):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--snap-times",
                            trees[who], "--layers", str(layers)],
                           capture_output=True, text=True, timeout=900)
        for line in p.stdout.splitlines():
            log(f"[{who}] {line}")
        if p.returncode != 0:
            log(p.stderr[-4000:])
            raise SystemExit(f"snap-ab: the {who} run failed (rc {p.returncode})")
        got = [ln for ln in p.stdout.splitlines() if ln.startswith("snap-ab: {")]
        runs.setdefault(who, []).append(json.loads(got[-1][len("snap-ab: "):]))
        log(f"snap-ab: {who} run in {time.perf_counter() - t0:.1f}s")
    digests = {r["digest"] for rs in runs.values() for r in rs}
    log(f"snap-ab: baseline and current outputs bit-equal: {len(digests) == 1}")
    if len(digests) != 1:
        raise SystemExit("snap-ab: the two checkouts' snap steps disagree")
    def turns(who, key):
        return " / ".join(f"{r[key]:.4f}" for r in runs[who])

    for key, what in (("segment", "fused_reuse kernel, vDiT grid segment (3, 24, 8192, "
                                  "128), contiguous: device"),
                      ("dit", "fused_reuse kernel, dit-xl2 (4, 16, 4096, 72), T = 1: "
                              "device"),
                      ("snap", "snap step (every kernel), vDiT served call (3, 24, "
                               "8448, 128), 256 text tokens: device"),
                      ("snap_forward", f"snap step a vDiT forward ({layers} layers, "
                                       "batch 3): device"),
                      ("other", "other family a vDiT forward without the snap range: "
                                "device"),
                      ("wall", "a vDiT forward: host wall")):
        b = sum(r[key] for r in runs["baseline"])
        c = sum(r[key] for r in runs["current"])
        host = ""
        if f"{key}_host" in runs["current"][0]:
            host = (f"; host a call baseline {turns('baseline', key + '_host')}, "
                    f"current {turns('current', key + '_host')} ms")
        log(f"snap-ab: {what} baseline {turns('baseline', key)} ms, current "
            f"{turns('current', key)} ms ({b / c:.3f}x){host}; {CARD}")
    return 0


def small_reference_check(label, name="vdit-paper", policy=None, overrides=()):
    """The smoke config's 12-step trajectory in f32 through the kernels on
    the card against the same trajectory through the plain versions on
    the CPU, same params, noise and conditioning (the DiT's class label
    comes from the request seed on the CPU)."""
    import numpy as np
    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import MODEL_INIT, build_sampler, serving_shape
    from repro_torch.launch.workloads import mixed_request_stream
    from repro_torch.serving.engine import request_noise

    arch = apply_overrides(get_smoke_config(name), overrides)
    init = MODEL_INIT[arch.family]
    shape_name = next(sp.name for sp in arch.shapes if sp.kind == "generate")
    shape = serving_shape(arch, shape_name, smoke=True, steps=SERVE_STEPS)
    # The text shape a request of this model carries (the unet's context).
    txt_shape = (1,) + mixed_request_stream(arch, (shape,), 1)[0][1].txt.shape
    outs, aux = {}, {}
    for dev in ("cuda", "cpu"):
        model = init(arch.model, seed=1, device="cpu", zero_init=False)
        model = model.to(dev)
        fn, lat_shape = build_sampler(arch, shape, model, policy=policy,
                                      compute_dtype=torch.float32)
        noise = request_noise(5, lat_shape, "cpu")[None].to(dev)
        txt = torch.from_numpy(0.05 * np.random.default_rng(5).standard_normal(
            txt_shape).astype(np.float32)).to(dev)
        out = fn(noise, txt, [5])
        if isinstance(out, tuple):  # a cache-aware sampler: (latents, counters)
            out, aux[dev] = out[0], {k: int(v) for k, v in out[1].items()}
        outs[dev] = out.float().cpu()
    diff = (outs["cuda"] - outs["cpu"]).norm() / outs["cpu"].norm()
    ok = bool(torch.isfinite(outs["cuda"]).all()) and diff.item() < 1e-3 \
        and aux.get("cuda") == aux.get("cpu")
    counters = (f"; decision cache card {aux['cuda']}, CPU {aux['cpu']}"
                if aux else "")
    log(f"reference[{label}]: {arch.name} {shape.img_res}² 12-step f32 trajectory, "
        f"card kernels vs CPU "
        f"plain versions: relative L2 {diff.item():.3e} (tol 1e-3){counters} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("card trajectory disagrees with the CPU reference")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Training (slice 18)
# ---------------------------------------------------------------------------

ADALN_GRAD_SHAPES = ((4, 256, 1152), (4, 4096, 1152))  # the DiT's (B, N, d)
# adaln[grad]: f32 is the closed form against autograd's chain, both in
# f32 (reassociation only); bf16 rounds each gradient once, the plain
# version's chain at other places: a few elements one bf16 ulp apart.
ADALN_GRAD_BAR = {"float32": 1e-5, "bfloat16": 1e-2}
# train[dit-xl2 grads]: d_model 144 (2 heads of 72), 2 layers, 32² images
# (a (1, 2, 2) grid), f32 compute, every leaf random.
DIT_GRADS_CUT = ("model.d_model=144", "model.num_heads=2", "model.num_layers=2")
DIT_GRADS_BAR = 1e-4   # tree relative L2, card against the CPU (f32, no TF32)
TRAIN_DIT_STEPS = 3
# Of 40 layers: about 16 GB a layer at 8448 tokens; 3 until slice 24, whose
# dist[train vdit-paper tp] covers the train step at full width.
TRAIN_VDIT_LAYERS = 2
TRAIN_VDIT_STEPS = 3
TRAIN_VISION_STEPS = 2
# train[vdit-example]: the JAX package's examples/train_vdit.py, 100 steps
# with a checkpoint every 50, from VDIT_EXAMPLE_SEEDS seeds.  Its loss on
# the CPU from scripts/reference_vdit_example_losses.py --seeds 8: the
# means over steps 0-19 and 80-99, averaged over the seeds, and of seed
# 0 (the example itself).
VDIT_EXAMPLE_STEPS = 100
VDIT_EXAMPLE_SEEDS = 8
VDIT_EXAMPLE_JAX = (0.7342202058061957, 0.26086535506183284)
VDIT_EXAMPLE_JAX_SEED0 = (0.716935034096241, 0.2274967030622065)
VDIT_EXAMPLE_DROP = 0.5      # last-20 mean at most half the first-20 mean
VDIT_EXAMPLE_TO_JAX = 0.25   # last-20 mean within 25% of the JAX run's
VDIT_EXAMPLE_KILL = 60       # killed after step 60, resumed from step 50
VDIT_EXAMPLE_RESUME_BAR = 1e-3  # params, resumed against uninterrupted


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def adaln_grad_phase():
    """adaln[grad]: the autograd Function (the kernel forward, the
    closed-form backward) against autograd of the plain version on the
    card, at the DiT's shapes, f32 and bf16; shift and scale are chunks
    of an adaLN projection, as the model passes them.  Returns the
    largest relative L2 error."""
    import torch
    from repro_torch.kernels.adaln.ops import adaln_modulate
    from repro_torch.kernels.adaln.ref import adaln_modulate_ref

    worst = 0.0
    g = torch.Generator(device="cuda")
    g.manual_seed(29)
    with torch.enable_grad():
        for B, N, d in ADALN_GRAD_SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                x = (2 * torch.randn((B, N, d), generator=g, device="cuda") + 0.5).to(dt)
                ada = torch.randn((B, 6 * d), generator=g, device="cuda").to(dt)
                gout = torch.randn((B, N, d), generator=g, device="cuda").to(dt)
                grads = []
                for fn in (adaln_modulate, adaln_modulate_ref):
                    xi = x.clone().requires_grad_(True)
                    ai = ada.clone().requires_grad_(True)
                    sh, sc = torch.chunk(ai, 6, dim=-1)[:2]
                    fn(xi, sh, sc).backward(gout)
                    grads.append((xi.grad, ai.grad[:, :d], ai.grad[:, d:2 * d]))
                torch.cuda.synchronize()
                name = str(dt).split(".")[-1]
                errs = [rel_err(a, b) for a, b in zip(*grads)]
                ok = all(e <= ADALN_GRAD_BAR[name] for e in errs) and all(
                    bool(torch.isfinite(a).all()) for a in grads[0])
                worst = max(worst, *errs)
                log(f"adaln[grad]: {(B, N, d)} {name}: dx {errs[0]:.3e}, dshift "
                    f"{errs[1]:.3e}, dscale {errs[2]:.3e} relative L2 against autograd "
                    f"of the plain version (bar {ADALN_GRAD_BAR[name]:.0e}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("adaln[grad]: the Function's gradient disagrees")
    return worst


def train_grads_phase():
    """train[dit-xl2 grads]: one step's gradients of a small dit-xl2 (every
    leaf random) through the adaLN kernel against the same step on the
    CPU (plain versions), f32 compute, the same batch, noise and t; every
    leaf's gradient non-zero on the card."""
    import copy

    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataSpec, batch_generator
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import workloads
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.params import init_model

    arch = apply_overrides(get_config("dit-xl2"), DIT_GRADS_CUT
                           + ("train.compute_dtype=float32",))
    shape = dataclasses.replace(arch.shape("train_256"), img_res=32, batch=4)
    base = init_model(arch.model, seed=3, device="cpu", zero_init=False)
    loss_fn = workloads.train_loss_fn(arch)
    grads, counts = {}, {}
    with torch.enable_grad():
        for dev in ("cuda", "cpu"):
            model = copy.deepcopy(base).to(dev)
            for p in model.parameters():
                p.requires_grad_(True)
            batch = make_batch_fn(arch, shape, dev)(DataSpec(seed=0), 0)
            reset_launch_counts()
            loss, _ = loss_fn(model, batch, batch_generator(0, 0, 0))
            loss.backward()
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = launch_counts()
            grads[dev] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    num = sum(float((grads["cuda"][n] - g).double().norm() ** 2) for n, g in grads["cpu"].items())
    den = sum(float(g.double().norm() ** 2) for g in grads["cpu"].values())
    tree = (num / den) ** 0.5
    zero = [n for n, g in grads["cuda"].items() if not bool((g != 0).any())]
    want = 2 * arch.model.num_layers + 1
    checks = {f"gradient tree relative L2 card vs CPU {tree:.3e} (bar {DIT_GRADS_BAR:.0e})":
              tree <= DIT_GRADS_BAR,
              f"every one of {len(grads['cuda'])} leaves has a non-zero gradient "
              f"(zero: {zero})": not zero,
              f"adaln launched {counts.get('adaln')} times in the forward (want {want})":
              counts.get("adaln") == want}
    report("dit-xl2 grads", checks, kind="train")
    return tree


@contextlib.contextmanager
def timed_train_steps(records):
    """Wrap the launcher's train step: CUDA events around each step, its
    metrics and the launch counters after it."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import workloads

    def make(orig):
        def make_step(arch, shape, model, mesh=None):
            step = orig(arch, shape, model, mesh=mesh)

            def timed(state, batch, seed):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                state, m = step(state, batch, seed)
                e1.record()
                torch.cuda.synchronize()
                records.append({"ms": e0.elapsed_time(e1), "counts": launch_counts(),
                                **{k: float(v) for k, v in m.items()}})
                return state, m
            return timed
        return make_step

    with wrapped(workloads, "train_step", make):
        yield


def train_cell(label, argv, batch, adaln_per_step=0, unit="samples", keep=False):
    """train[label]: ``repro_torch.launch.train.main(argv)`` on the card,
    the launch counters set to 0 just before and read just after; per
    step the loss (and the LM's nll and aux), grad_norm, lr, ms (CUDA
    events) and launches; after the first step the mean ms and ``batch``
    ``unit`` a second; the peak memory.  Every step must launch
    ``adaln_per_step`` adaLN kernels and no other.  With ``keep`` the
    result holds the trained state under ``state``."""
    import math

    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_lib

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # what earlier phases keep
    records = []
    reset_launch_counts()
    t0 = time.perf_counter()
    with timed_train_steps(records):
        state, _ = train_lib.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = sum(p.numel() for p in state.params.parameters())
    if not keep:
        del state
        torch.cuda.empty_cache()
    prev = {k: 0 for k in counts}
    per_step = []
    for i, r in enumerate(records):
        step = {k: r["counts"][k] - prev[k] for k in counts}
        prev = r["counts"]
        per_step.append(step)
        lm = "".join(f", {k} {r[k]:.6f}" for k in ("nll", "aux") if k in r)
        log(f"train[{label}]: step {i}: loss {r['loss']:.6f}{lm}, grad_norm "
            f"{r['grad_norm']:.6f}, lr {r['lr']:.6e}, {r['ms']:.3f} ms, launches "
            f"{ {k: v for k, v in step.items() if v} }")
    later = [r["ms"] for r in records[1:]]
    ms = sum(later) / len(later)
    log(f"train[{label}]: {n / 1e9:.4f} B params; {len(records)} steps of {batch} {unit} in "
        f"{wall:.1f}s (init, data and first step included); {ms:.3f} ms a step after "
        f"the first ({', '.join(f'{x:.3f}' for x in later)}), {batch / ms * 1e3:.1f} "
        f"{unit}/s; peak {peak:.2f} GiB, {peak - held:.2f} of it the run's ({held:.2f} "
        f"held before it); {CARD}")
    want = {k: (adaln_per_step if k == "adaln" else 0) for k in counts}
    checks = {f"every step's loss and grad_norm finite": all(
                  math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                  for r in records),
              f"every step launched {want} (counts over the run {counts})":
                  all(s == want for s in per_step)
                  and counts["adaln"] == adaln_per_step * len(records)}
    report(label, checks, kind="train")
    out = {"steps": len(records), "ms": ms, f"{unit}_per_s": batch / ms * 1e3,
           "peak_gib": peak, "own_peak_gib": peak - held, "launches": counts,
           "loss": [r["loss"] for r in records], "records": records}
    if keep:
        out["state"] = state
    return out


def profile_train_dit():
    """profile[train dit-xl2]: one AdamW step of dit-xl2 at full width and
    depth on one micro-batch (32 images, grad_accum 1), by kernel family:
    the adaLN kernel, softmax, the AdamW ``_foreach`` passes, reductions,
    GEMMs and the rest."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataSpec, batch_generator
    from repro_torch.launch import workloads
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.params import init_model
    from repro_torch.training import train_loop

    arch = get_config("dit-xl2")
    arch = dataclasses.replace(arch, train=dataclasses.replace(arch.train, grad_accum=1))
    shape = dataclasses.replace(arch.shape("train_256"), batch=32)
    model = init_model(arch.model, seed=0, device="cuda")
    step = workloads.train_step(arch, shape, model)
    box = [train_loop.train_state_init(model, arch.train)]
    batch = make_batch_fn(arch, shape, "cuda")(DataSpec(seed=0), 0)

    def call():
        box[0], _ = step(box[0], batch, 0)

    out = profile_call("train dit-xl2", call,
                       {"adaln": "adaln", "softmax": "softmax", "adamw": "multi_tensor",
                        "reduce": "reduce"},
                       what="one train step", desc="batch 32 (one micro-batch of "
                       "train_256): forward, backward and AdamW, bf16 compute")
    del box, model, batch
    torch.cuda.empty_cache()
    return out


def vdit_example_arch(steps):
    """The JAX package's examples/train_vdit.py configuration in the
    port's dataclasses: a ~35 M video DiT (6 layers, width 384), lr 1e-3,
    warmup 20, remat off, batch 4 of 64² x 16 frames."""
    from repro_torch.config.base import ShapeSpec, VDiTConfig
    from repro_torch.configs import get_config

    model = VDiTConfig(frames=16, img_res=64, patch=2, t_patch=1, num_layers=6,
                       d_model=384, num_heads=6, in_channels=8, vae_factor=8,
                       t_vae_factor=4, txt_tokens=16, txt_dim=256, axes_dim=(16, 24, 24))
    base = get_config("vdit-paper")
    return dataclasses.replace(
        base, name="vdit-example", model=model,
        shapes=(ShapeSpec(name="train_64", kind="train", img_res=64, batch=4,
                          steps=1000),),
        train=dataclasses.replace(base.train, learning_rate=1e-3, warmup_steps=20,
                                  total_steps=steps, remat=False))


class _Killed(Exception):
    """Stops a training run mid-way, as a crash would."""


def example_run(arch, shape, device, steps, ckpt_dir=None, kill_after=None, seed=0,
                loop_seed=None, metric="loss"):
    """A training run of ``arch`` at ``shape`` on ``device`` through the
    launcher's pieces: the reference init from ``seed`` drawn on the CPU,
    data seed ``seed``, step seed ``loop_seed`` (default ``seed``); with
    ``ckpt_dir`` a checkpoint every 50 steps (keep 2) and auto-resume from
    the newest valid one.  Returns (state, {step: metric}, start step);
    ``kill_after`` steps stops the run by an exception once that many
    steps are done (the step-50 checkpoint committed)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.synthetic import DataSpec, batch_iterator
    from repro_torch.launch import workloads
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.params import init_model
    from repro_torch.training import train_loop

    model = init_model(arch.model, seed=seed, device="cpu").to(device)
    step_fn = workloads.train_step(arch, shape, model)
    state = train_loop.train_state_init(model, arch.train)
    ckpt, start = None, 0
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir, keep=2)
        found, arrays, _ = ckpt.restore_latest()
        if found is not None:
            state = train_loop.load_state_tree(state, arrays)
            start = found
    values = {}

    def on_step(i, m):
        values[i] = float(m[metric])
        if kill_after is not None and i + 1 == kill_after:
            raise _Killed

    it = batch_iterator(make_batch_fn(arch, shape, device), DataSpec(seed=seed),
                        start_index=start)
    try:
        state, _ = train_loop.run_train_loop(
            step_fn, state, it, steps, seed=seed if loop_seed is None else loop_seed,
            checkpointer=ckpt, checkpoint_every=50, log_every=0,
            start_step=start, on_step=on_step)
    except _Killed:
        pass
    if ckpt:
        ckpt.wait()
    return state, values, start


def vdit_example_run(device, steps, ckpt_dir=None, kill_after=None, seed=0):
    """The example's run (:func:`example_run`) from ``seed``: the
    reference init from seed, data seed seed, step seed seed + 1 (seed 0:
    the example's own 0, 0 and 1)."""
    arch = vdit_example_arch(steps)
    return example_run(arch, arch.shape("train_64"), device, steps, ckpt_dir,
                       kill_after, seed, loop_seed=seed + 1)


def vdit_example_phase():
    """train[vdit-example]: the example's 100 steps on the card from
    VDIT_EXAMPLE_SEEDS seeds (seed 0: the example's own, with a
    checkpoint every 50 steps).  The mean loss over steps 80-99 must fall
    to at most VDIT_EXAMPLE_DROP of the mean over steps 0-19, and,
    averaged over the seeds, lie within 25% of the JAX example's on the
    CPU averaged over as many seeds: one run's 20-step mean moves by
    about +-30% with its draws of t alone (the port replaying the JAX
    example's own draws on the CPU gives its means to 5 digits).  Then a
    run killed after step 60 and restarted from its step-50 checkpoint
    must end on the uninterrupted run's parameters (bar
    VDIT_EXAMPLE_RESUME_BAR; cuBLAS and atomics need not be bitwise
    deterministic on the card)."""
    import shutil

    import torch

    root = os.path.join(ROOT, "build", "train_vdit_example")
    shutil.rmtree(root, ignore_errors=True)
    means = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for seed in range(VDIT_EXAMPLE_SEEDS):
        state, losses, _ = vdit_example_run(
            "cuda", VDIT_EXAMPLE_STEPS, os.path.join(root, "full") if seed == 0 else None,
            seed=seed)
        traj = [losses[i] for i in range(VDIT_EXAMPLE_STEPS)]
        means.append((sum(traj[:20]) / 20, sum(traj[-20:]) / 20))
        if seed == 0:
            full = state
            log(f"train[vdit-example]: seed 0 loss every 10th step "
                f"{[round(traj[i], 4) for i in range(0, VDIT_EXAMPLE_STEPS, 10)]}")
        else:
            del state
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    first = sum(m[0] for m in means) / len(means)
    last = sum(m[1] for m in means) / len(means)
    j_first, j_last = VDIT_EXAMPLE_JAX
    log(f"train[vdit-example]: {VDIT_EXAMPLE_SEEDS} runs of {VDIT_EXAMPLE_STEPS} steps in "
        f"{wall:.1f}s; means over steps 0-19 / 80-99 by seed "
        f"{[(round(a, 4), round(b, 4)) for a, b in means]}, averaged {first:.4f} / "
        f"{last:.4f}; the JAX example on the CPU averaged over as many seeds "
        f"{j_first:.4f} / {j_last:.4f} (its seed 0 {VDIT_EXAMPLE_JAX_SEED0[0]:.4f} / "
        f"{VDIT_EXAMPLE_JAX_SEED0[1]:.4f}; the port's seed 0 against it "
        f"{means[0][1] / VDIT_EXAMPLE_JAX_SEED0[1] - 1:+.1%}); {CARD}")
    d = os.path.join(root, "killed")
    _, part, _ = vdit_example_run("cuda", VDIT_EXAMPLE_STEPS, d,
                                  kill_after=VDIT_EXAMPLE_KILL)
    resumed, rest, start = vdit_example_run("cuda", VDIT_EXAMPLE_STEPS, d)
    got = {n: p.detach() for n, p in resumed.params.named_parameters()}
    want = {n: p.detach() for n, p in full.params.named_parameters()}
    num = sum(float((got[n] - w).double().norm() ** 2) for n, w in want.items())
    den = sum(float(w.double().norm() ** 2) for w in want.values())
    err = (num / den) ** 0.5
    bitwise = all(bits_equal(got[n], w) for n, w in want.items())
    checks = {
        f"every run's loss falls: mean 80-99 <= {VDIT_EXAMPLE_DROP} x mean 0-19":
            all(b <= VDIT_EXAMPLE_DROP * a for a, b in means),
        f"mean 80-99 averaged over seeds {last:.4f} within {VDIT_EXAMPLE_TO_JAX:.0%} of "
        f"the JAX example's {j_last:.4f} ({last / j_last - 1:+.1%})":
            abs(last / j_last - 1) <= VDIT_EXAMPLE_TO_JAX,
        f"killed after step {max(part) + 1}, resumed from step {start} (want 50), ran "
        f"steps {min(rest)}-{max(rest)}": start == 50 and min(rest) == 50
            and max(rest) == VDIT_EXAMPLE_STEPS - 1,
        f"resumed parameters against the uninterrupted run's: relative L2 {err:.3e} "
        f"(bar {VDIT_EXAMPLE_RESUME_BAR:.0e}), bit-equal {bitwise}":
            err <= VDIT_EXAMPLE_RESUME_BAR}
    report("vdit-example", checks, kind="train")
    shutil.rmtree(root, ignore_errors=True)
    return {"first20": first, "last20": last, "by_seed": means,
            "resume_rel_l2": err, "bit_equal": bitwise}


def train_reference_check():
    """reference[train dit-b2 smoke]: the launcher's steps in f32 compute
    on the card against the same steps on the CPU (the same CPU-drawn
    init, batches, noise and t): params within 1e-5 relative L2."""
    import torch
    from repro_torch.launch import train as train_lib

    argv = ["--arch", "dit-b2", "--shape", "train_256", "--smoke", "--batch-override",
            "4", "--steps", "2", "train.compute_dtype=float32"]
    out = {}
    for dev in ("cuda", "cpu"):
        state, hist = train_lib.main(argv + ["--device", dev])
        out[dev] = ({n: p.detach().cpu() for n, p in state.params.named_parameters()},
                    hist[-1]["loss"])
    num = sum(float((out["cuda"][0][n] - p).double().norm() ** 2)
              for n, p in out["cpu"][0].items())
    den = sum(float(p.double().norm() ** 2) for p in out["cpu"][0].values())
    err = (num / den) ** 0.5
    ok = err <= 1e-5
    log(f"reference[train dit-b2 smoke]: 2 AdamW steps, f32 compute, card vs CPU: params "
        f"relative L2 {err:.3e} (tol 1e-5), loss {out['cuda'][1]:.6f} vs "
        f"{out['cpu'][1]:.6f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("card training step disagrees with the CPU reference")


# ---------------------------------------------------------------------------
# dist[train dit-xl2] (slice 20): the training launcher under torchrun
# ---------------------------------------------------------------------------

DIST_DIR = os.path.join(ROOT, "build", "dist")
DIST_REL = 1e-6   # per-step losses and final params, against the plain run


def train_worker(out, argv):
    """``chip_smoke.py --train-worker OUT ARGV...``, the process torchrun
    starts for ``dist[train ...]``: ``repro_torch.launch.train.main(ARGV)``
    with every step timed as ``train_cell`` times it (CUDA events,
    :func:`timed_train_steps`); rank 0 writes the steps' records, the
    run's launch counts, the rank count and the backend to OUT as JSON."""
    import json

    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_lib

    records = []
    reset_launch_counts()
    with timed_train_steps(records):
        train_lib.main(argv)
    torch.cuda.synchronize()
    if dist.get_rank() == 0:
        with open(out, "w", encoding="utf-8") as f:
            json.dump({"steps": records, "launches": launch_counts(),
                       "ranks": dist.get_world_size(),
                       "backend": dist.get_backend()}, f, indent=1)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def torchrun_start(label, out, argv):
    """Start ``python -m torch.distributed.run --standalone
    --nproc_per_node 1 chip_smoke.py --train-worker OUT ARGV`` from the
    checkout (its host threads as many as this process's: torchrun would
    set 1); returns (process, start time)."""
    import torch

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.join(ROOT, "chip_smoke.py"),
           "--train-worker", out, *argv]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    log(f"dist[{label}]: {' '.join(cmd[1:])}")
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter()


def torchrun_until(started, marker):
    """Read a :func:`torchrun_start` process's output until a line holds
    ``marker`` (or the output ends); the lines read are kept with it."""
    proc = started[0]
    seen = started[2] if len(started) > 2 else []
    for line in proc.stdout:
        seen.append(line.rstrip("\n"))
        if marker in line:
            break
    return (proc, started[1], seen)


def torchrun_finish(label, started, timeout=600):
    """Join a :func:`torchrun_start` process: its exit code must be 0;
    returns (wall seconds, its log lines)."""
    proc, t0 = started[:2]
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    lines = (started[2] if len(started) > 2 else []) + text.strip().splitlines()
    if proc.returncode != 0:
        for ln in lines[-40:]:
            log(f"dist[{label}]: | {ln}")
        raise SystemExit(f"dist[{label}]: exit {proc.returncode}")
    for ln in lines:
        if "rank mesh" in ln or "training done" in ln:
            log(f"dist[{label}]: | {ln.strip()}")
    log(f"dist[{label}]: exit 0 after {wall:.1f}s (process start, NCCL and the "
        f"model's CPU init included)")
    return wall, lines


def _summary_ms(summary):
    later = [r["ms"] for r in summary["steps"][1:]]
    return sum(later) / len(later)


def dist_train_phase(plain):
    """``dist[train dit-xl2]``: the launcher under torchrun at one rank
    over NCCL, dit-xl2 at full width and depth on train_256 (batch 256 in
    8 micro-batches), TRAIN_DIT_STEPS steps with the parameters,
    gradients and AdamW state sharded by the rule tables
    (``distributed.fsdp``); its per-step losses and final params (from
    its checkpoint) within DIST_REL relative of ``train[dit-xl2]``'s
    (``plain``, the same seed, its state kept), with the same adaLN
    launches, and its ms a step beside that run's (both by CUDA events
    around each step, :func:`train_worker`).  Then the same with
    ``train.grad_compression=true`` (started once the first has logged
    its last step): its first loss within DIST_REL of the plain run's,
    every loss finite, the same launches.  Before the runs, one
    micro-batch's gradients of the kept model are compressed on the card,
    from a non-zero residual, bit-equal to ``compress_grads`` on the CPU
    applied to the same tensors."""
    import json
    import math
    import shutil

    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpointer as ckpt_lib
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataSpec, batch_generator
    from repro_torch.distributed.collectives import (CompressionState,
                                                     compress_grads)
    from repro_torch.launch import workloads
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.params import load_jax_arrays

    ck = os.path.join(DIST_DIR, "ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    base = ["--arch", "dit-xl2", "--shape", "train_256", "--steps", str(TRAIN_DIT_STEPS)]
    runs = (("dit-xl2", ["--ckpt-dir", ck, "--ckpt-every", str(TRAIN_DIT_STEPS)], []),
            ("dit-xl2 int8", [], ["train.grad_compression=true"]))
    paths = {n: os.path.join(DIST_DIR, f"{n.replace(' ', '_')}.json") for n, _, _ in runs}

    def argv(name, extra, over):
        return base + extra + over

    # One micro-batch's gradients of the kept model, compressed on the card
    # and on the CPU from the same residual (before the runs: three
    # processes' worth of dit-xl2 training does not fit the card).
    model = plain["state"].params
    arch = get_config("dit-xl2")
    shape = dataclasses.replace(arch.shape("train_256"), batch=32)
    batch = make_batch_fn(arch, shape, "cuda")(DataSpec(seed=0), 0)
    params = list(model.parameters())
    for p in params:
        p.grad = None
    with torch.enable_grad():
        loss, _ = workloads.train_loss_fn(arch)(model, batch, batch_generator(0, 0, 0))
        loss.backward()
    grads = [p.grad.detach() for p in params]
    for p in params:
        p.grad = None
    # A residual of a quarter of another leaf's scale: q(dq(g) + e) with e != 0.
    errs = [0.25 * torch.roll(g.float(), 1) for g in grads]
    cpu_grads, cpu_errs = [g.cpu() for g in grads], [e.cpu() for e in errs]
    t0 = time.perf_counter()
    out_card, st_card = compress_grads(grads, CompressionState(errs))
    torch.cuda.synchronize()
    out_cpu, st_cpu = compress_grads(cpu_grads, CompressionState(cpu_errs))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(out_card, out_cpu)) and all(
        torch.equal(a.cpu(), b) for a, b in zip(st_card.error, st_cpu.error))
    n_elems = sum(g.numel() for g in grads)
    log(f"dist[train dit-xl2 int8]: one micro-batch's gradients ({n_elems / 1e6:.1f} M "
        f"elements, {len(grads)} tensors, loss {float(loss):.6f}) compressed from a "
        f"non-zero residual on the card and on the CPU: gradients and residuals bit-equal "
        f"{same} ({time.perf_counter() - t0:.1f}s)")
    del grads, errs, cpu_grads, cpu_errs, out_card, out_cpu, st_card, st_cpu, batch
    torch.cuda.empty_cache()
    # The second run starts once the first has logged its last step: its
    # CPU init overlaps the first's checkpoint write, not its steps.
    first = torchrun_until(torchrun_start("train dit-xl2", paths["dit-xl2"],
                                          argv(*runs[0])),
                           f"step {TRAIN_DIT_STEPS - 1} loss")
    second = torchrun_start("train dit-xl2 int8", paths["dit-xl2 int8"],
                            argv(*runs[1]))
    done = {"dit-xl2": torchrun_finish("train dit-xl2", first)}
    done["dit-xl2 int8"] = torchrun_finish("train dit-xl2 int8", second)
    plain_ms = plain["ms"]
    out = {}
    for name, _, _ in runs:
        with open(paths[name], encoding="utf-8") as f:
            summ = json.load(f)
        wall, lines = done[name]
        losses = [r["loss"] for r in summ["steps"]]
        ms = _summary_ms(summ)
        norms = ", ".join(f"{r['grad_norm']:.6f}" for r in summ["steps"])
        later = ", ".join(f"{r['ms']:.3f}" for r in summ["steps"][1:])
        fired = {k: v for k, v in summ["launches"].items() if v}
        log(f"dist[train {name}]: per step loss {', '.join(f'{x:.6f}' for x in losses)} "
            f"(train[dit-xl2]: {', '.join(f'{x:.6f}' for x in plain['loss'])}); "
            f"grad_norm {norms}; {ms:.3f} ms a step after the first ({later}) by CUDA "
            f"events around each step, train[dit-xl2] {plain_ms:.3f} ms the same way "
            f"({ms / plain_ms:.4f}x); launches {fired}; {summ['ranks']} rank over "
            f"{summ['backend']}; {CARD}")
        out[name] = {"loss": losses, "ms": ms, "plain_ms": plain_ms,
                     "launches": summ["launches"], "wall_s": wall,
                     "ranks": summ["ranks"], "nccl": summ["backend"] == "nccl"}
    # Final params: the torchrun run's checkpoint against the kept state,
    # leaf by leaf on the card.
    step = ckpt_lib.Checkpointer(ck, async_save=False).list_steps()[-1]
    params = list(model.parameters())
    of = {id(p): i for i, p in enumerate(params)}
    whole = [torch.empty_like(p) for p in params]
    with np.load(os.path.join(ckpt_lib._step_dir(ck, step), ckpt_lib._ARRAYS)) as z:
        load_jax_arrays(model, z, "params", lambda p: whole[of[id(p)]])
    num = sum(float(torch.sum((p.double() - w.double()) ** 2))
              for p, w in zip(params, whole))
    den = sum(float(torch.sum(p.double() ** 2)) for p in params)
    param_rel = math.sqrt(num / den)
    del whole
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(out["dit-xl2"]["loss"],
                                                      plain["loss"]))
    log(f"dist[train dit-xl2]: checkpoint step {step}: params relative L2 {param_rel:.3e} "
        f"against train[dit-xl2]'s state, per-step losses within {loss_rel:.3e} (tol "
        f"{DIST_REL:g})")
    ad = plain["launches"]["adaln"]
    comp = out["dit-xl2 int8"]
    checks = {
        f"per-step losses within {DIST_REL:g} of train[dit-xl2]'s": loss_rel <= DIST_REL
        and len(out["dit-xl2"]["loss"]) == len(plain["loss"]),
        f"final params within {DIST_REL:g} relative L2 (checkpoint of step {step})":
            param_rel <= DIST_REL and step == TRAIN_DIT_STEPS,
        f"the same adaLN launches ({ad}) and no other kernel's":
            out["dit-xl2"]["launches"] == plain["launches"],
        "one rank over NCCL": all(
            out[n]["ranks"] == 1 and out[n]["nccl"] for n in ("dit-xl2", "dit-xl2 int8")),
        f"compressed: first loss within {DIST_REL:g} of the plain run's, every loss "
        "finite, the same launches":
            abs(comp["loss"][0] - plain["loss"][0]) <= DIST_REL * abs(plain["loss"][0])
        and all(math.isfinite(x) for x in comp["loss"])
        and comp["launches"] == plain["launches"],
        "compressed gradients and residuals bit-equal card vs CPU": same,
    }
    report("train dit-xl2", checks, kind="dist")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    out["params_rel"], out["loss_rel"] = param_rel, loss_rel
    return out


def train_phases():
    """The training cells, each through the launcher's main: dit-xl2 at full
    width and depth (batch 256, grad_accum 8, bf16 compute), vdit-paper at
    full width and TRAIN_VDIT_LAYERS layers (batch 64 cut to 1),
    vit-l16 and efficientnet-b7 at cls_224 (batch 256, remat), then the
    vdit example with its kill and resume; and, on the kept dit-xl2
    state, ``dist[train dit-xl2]``."""
    import torch

    out = {"dit-xl2 grads": train_grads_phase()}
    import shutil

    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    out["dit-xl2"] = train_cell(
        "dit-xl2", ["--arch", "dit-xl2", "--shape", "train_256", "--steps",
                    str(TRAIN_DIT_STEPS)], 256,
        adaln_per_step=8 * (2 * 28 + 1), keep=True)
    out["dist dit-xl2"] = dist_train_phase(out["dit-xl2"])
    del out["dit-xl2"]["state"]
    torch.cuda.empty_cache()
    out["profile dit-xl2"] = profile_train_dit()
    out["vdit-paper"] = train_cell(
        f"vdit-paper {TRAIN_VDIT_LAYERS} layers",
        ["--arch", "vdit-paper", "--shape", "train_256", "--steps", str(TRAIN_VDIT_STEPS),
         "--batch-override", "1", f"model.num_layers={TRAIN_VDIT_LAYERS}"], 1)
    for name in ("vit-l16", "efficientnet-b7"):
        out[name] = train_cell(name, ["--arch", name, "--shape", "cls_224", "--steps",
                                      str(TRAIN_VISION_STEPS)], 256)
    out["vdit-example"] = vdit_example_phase()
    return out


# ---------------------------------------------------------------------------
# 8j. LM training (slice 19): gemma3-4b and qwen2-moe-a2.7b through the
# launcher; no kernel of the port lies on this path
# ---------------------------------------------------------------------------

# train[gemma3-4b grads]: full width, 2 of 34 layers, f32 compute, 1 x 1024
# tokens: 1024 x 262144 logit cells exceed the budget, so the cross entropy
# runs in two 512-token chunks.
LM_GRADS_CUT = ("model.num_layers=2", "train.compute_dtype=float32")
LM_GRADS_TOKENS = 1024
LM_GRADS_BAR = 1e-4   # tree relative L2, card against the CPU (f32, no TF32)
# train[gemma3-4b]: train_4k (4096 tokens) through the launcher, the global
# batch 256 cut to 8, so grad_accum 8 takes micro-batches of 1 sequence;
# 28 of 34 layers, else the deepest of these that fits.  All 34 peak at
# 75.45-75.51 GiB of the card's 79.18 and ran out of memory on one run; the
# retry at 28 then cost a second CPU init (40-60 s), so the run starts there.
LM_TRAIN_BATCH = 8
LM_TRAIN_STEPS = 3
LM_TRAIN_DEPTHS = (28, 22, 16)
# The first step's nll within 2% of its value at the reference init: the
# head's N(0, 0.02^2) weights against the final RMSNorm's unit-RMS
# output give logits of variance d_model * 0.02^2 (1.02 at gemma3-4b's
# width), and the mean cross entropy of V such logits is ln V + var / 2
# (12.989), not ln V (12.477): a near-uniform softmax only at small width.
LM_FIRST_NLL_BAR = 0.02
MOE_TRAIN_LAYERS = 4      # of 24: about 49 GB of f32 params, gradients, moments
# train[lm-smoke learn]: gemma3-4b's smoke config, train_4k cut to 8 x 256
# tokens, 100 steps from 8 seeds, a checkpoint every 50.  The JAX
# launcher's nll at the same cut on the CPU, from
# scripts/reference_lm_smoke_losses.py --steps 100 --seeds 8: the means
# over steps 0-19 and 80-99, averaged over the seeds.
LM_LEARN_SHAPE = (8, 256)   # (global batch, tokens)
LM_LEARN_STEPS = 100
LM_LEARN_SEEDS = 8
LM_LEARN_JAX = (5.544715601205826, 4.904278343915939)
LM_LEARN_TO_JAX = 0.25      # the last-20 average within 25% of the JAX one
LM_LEARN_KILL = 60          # killed after step 60, resumed from step 50


def lm_train_grads_phase():
    """train[gemma3-4b grads]: the LM loss and its gradients of a 2-layer
    gemma3-4b at full width (every leaf random) on the card against the
    same on the CPU, f32 compute, the same 1 x 1024 token batch, through
    the chunked cross entropy; every leaf's gradient non-zero on the
    card and no kernel of the port launched."""
    import copy

    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataSpec, batch_generator
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import workloads
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import transformer_lm
    from repro_torch.models.params import init_model

    arch = apply_overrides(get_config("gemma3-4b"), LM_GRADS_CUT)
    shape = dataclasses.replace(arch.shape("train_4k"), seq_len=LM_GRADS_TOKENS,
                                global_batch=1)
    base = init_model(arch.model, seed=5, device="cuda", zero_init=False)  # drawn fast
    n = sum(p.numel() for p in base.parameters())
    loss_fn = workloads.train_loss_fn(arch)
    grads, nll, secs, chunks = {}, {}, {}, {"cuda": [], "cpu": []}
    counts = {}
    for dev in ("cuda", "cpu"):
        def spy(orig, dev=dev):
            def f(h, t, head):
                chunks[dev].append(h.shape[1])
                return orig(h, t, head)
            return f

        model = base if dev == "cuda" else copy.deepcopy(base).to(dev)
        for p in model.parameters():
            p.requires_grad_(True)
        batch = make_batch_fn(arch, shape, dev)(DataSpec(seed=0), 0)
        reset_launch_counts()
        with torch.enable_grad(), wrapped(transformer_lm, "_chunk_ce", spy):
            (loss, m), secs[dev] = timed(lambda: loss_fn(model, batch, batch_generator(0, 0, 0)))
            _, back = timed(loss.backward)
        secs[dev] += back
        if dev == "cuda":
            counts = launch_counts()
        nll[dev] = float(m["nll"])
        grads[dev] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        del model, loss, m, batch
    del base
    torch.cuda.empty_cache()
    num = sum(float((grads["cuda"][n] - g).double().norm() ** 2) for n, g in grads["cpu"].items())
    den = sum(float(g.double().norm() ** 2) for g in grads["cpu"].values())
    tree = (num / den) ** 0.5
    zero = [k for k, g in grads["cuda"].items() if not bool((g != 0).any())]
    log(f"train[gemma3-4b grads]: {n / 1e9:.3f} B params (2 of 34 layers, full width), 1 x "
        f"{LM_GRADS_TOKENS} tokens, f32: nll card {nll['cuda']:.6f} / CPU {nll['cpu']:.6f}; "
        f"loss and backward {secs['cuda']:.2f} s on the card, {secs['cpu']:.2f} s on the CPU; "
        f"cross-entropy chunks of {chunks['cuda']} tokens (forward, then recomputed); {CARD}")
    checks = {f"gradient tree relative L2 card vs CPU {tree:.3e} (bar {LM_GRADS_BAR:.0e})":
              tree <= LM_GRADS_BAR,
              f"every one of {len(grads['cuda'])} leaves has a non-zero gradient "
              f"(zero: {zero})": not zero,
              f"the chunked cross entropy ran: two 512-token chunks, each recomputed "
              f"(card {chunks['cuda']}, CPU {chunks['cpu']})":
              chunks["cuda"] == chunks["cpu"] == [512] * 4,
              f"no kernel of the port launched ({counts})": not any(counts.values())}
    report("gemma3-4b grads", checks, kind="train")
    return tree


def lm_train_argv(name, layers):
    return ["--arch", name, "--shape", "train_4k", "--steps", str(LM_TRAIN_STEPS),
            "--batch-override", str(LM_TRAIN_BATCH), f"model.num_layers={layers}"]


def lm_train_gemma():
    """train[gemma3-4b]: the launcher's ``main`` at train_4k, full width,
    micro-batch 1 of LM_TRAIN_BATCH sequences (grad_accum 8), at the
    first depth of LM_TRAIN_DEPTHS that fits (28 layers: 63.8 GB of f32
    params, gradients and AdamW moments); the first step's nll against
    ln V; then ``profile[train gemma3-4b]`` on the trained state."""
    import gc
    import math

    import torch
    from repro_torch.configs import get_config

    full = get_config("gemma3-4b").model
    for layers in LM_TRAIN_DEPTHS:
        label = "gemma3-4b" if layers == full.num_layers else f"gemma3-4b {layers} layers"
        try:
            out = train_cell(label, lm_train_argv("gemma3-4b", layers),
                             LM_TRAIN_BATCH * 4096, unit="tokens", keep=True)
            break
        except torch.cuda.OutOfMemoryError:
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"train[gemma3-4b]: {layers} layers do not fit: out of memory at a peak of "
                f"{peak:.2f} GiB; trying fewer layers")
        gc.collect()  # the failed run's frames go with the exception
        torch.cuda.empty_cache()
    else:
        raise SystemExit(f"train[gemma3-4b]: no depth of {LM_TRAIN_DEPTHS} fits")
    first = out["records"][0]["nll"]
    uniform = math.log(full.vocab_size)
    want = uniform + full.d_model * 0.02 ** 2 / 2
    depth = (f"{layers} of {full.num_layers} layers" if layers < full.num_layers
             else f"all {layers} layers")
    log(f"train[{label}]: cuts: global batch 256 -> {LM_TRAIN_BATCH} (micro-batch 1, "
        f"grad_accum 8), {depth}; first nll {first:.6f} against ln {full.vocab_size} = "
        f"{uniform:.6f} ({first / uniform - 1:+.2%}) and ln V + d_model * 0.02^2 / 2 = "
        f"{want:.6f} ({first / want - 1:+.2%})")
    report(label, {f"the first step's nll within {LM_FIRST_NLL_BAR:.0%} of ln V + "
                   f"d_model * 0.02^2 / 2": abs(first / want - 1) <= LM_FIRST_NLL_BAR},
           kind="train")
    out["layers"] = layers
    out["profile"] = profile_train_lm(out.pop("state"), layers)
    return out


def profile_train_lm(state, layers):
    """profile[train gemma3-4b]: one AdamW step on one micro-batch (1 x
    4096 tokens, grad_accum 1) of the trained state, by kernel family:
    GEMMs, elementwise, softmax and reduction kernels, the cross-entropy
    chunks (their forward and recompute) and the AdamW update."""
    import torch
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataSpec
    from repro_torch.launch import workloads
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import transformer_lm
    from repro_torch.training import train_loop

    arch = apply_overrides(get_config("gemma3-4b"), (f"model.num_layers={layers}",
                                                     "train.grad_accum=1"))
    shape = dataclasses.replace(arch.shape("train_4k"), global_batch=1)
    step = workloads.train_step(arch, shape, state.params)
    box = [state]
    batch = make_batch_fn(arch, shape, "cuda")(DataSpec(seed=0), 0)

    def call():
        box[0], _ = step(box[0], batch, 0)

    out = profile_call("train gemma3-4b", call,
                       {"softmax": "softmax", "reduce": "reduce", "elementwise": "elementwise"},
                       annotate=[(transformer_lm, "_chunk_ce", "ce_chunks"),
                                 (train_loop, "adamw_update", "adamw")],
                       what="one train step", desc=f"1 x 4096 tokens (one micro-batch of "
                       f"train_4k), {layers} layers: forward, backward and AdamW, bf16 compute, "
                       f"remat; ce_chunks counts the chunks' forward and recompute only")
    del box, state, batch
    torch.cuda.empty_cache()
    return out


def lm_train_moe():
    """train[qwen2-moe-a2.7b 4 layers]: the launcher's ``main`` at train_4k,
    full width, MOE_TRAIN_LAYERS of 24 layers, micro-batch 1 of
    LM_TRAIN_BATCH sequences; the router's aux (summed over the layers)
    of each step."""
    from repro_torch.configs import get_config

    full = get_config("qwen2-moe-a2.7b").model
    label = f"qwen2-moe-a2.7b {MOE_TRAIN_LAYERS} layers"
    out = train_cell(label, lm_train_argv("qwen2-moe-a2.7b", MOE_TRAIN_LAYERS),
                     LM_TRAIN_BATCH * 4096, unit="tokens")
    aux = [r["aux"] for r in out["records"]]
    log(f"train[{label}]: cuts: global batch 256 -> {LM_TRAIN_BATCH} (micro-batch 1, "
        f"grad_accum 8), depth {full.num_layers} -> {MOE_TRAIN_LAYERS}; router aux summed over "
        f"the layers, mean over the micro-batches, by step {[round(a, 6) for a in aux]}; "
        f"first nll {out['records'][0]['nll']:.6f}")
    report(label, {"the router's aux loss positive and finite every step":
                   all(0 < a < float("inf") for a in aux)}, kind="train")
    return out


def lm_learn_arch():
    """(arch, shape): gemma3-4b's smoke config with train_4k cut to
    LM_LEARN_SHAPE."""
    from repro_torch.configs import get_smoke_config

    arch = get_smoke_config("gemma3-4b")
    batch, tokens = LM_LEARN_SHAPE
    shape = dataclasses.replace(arch.shape("train_4k"), seq_len=tokens, global_batch=batch)
    return dataclasses.replace(arch, shapes=tuple(
        shape if s.name == shape.name else s for s in arch.shapes)), shape


def lm_learn_phase():
    """train[lm-smoke learn]: the smoke gemma3-4b trained LM_LEARN_STEPS
    steps on the card from LM_LEARN_SEEDS seeds (seed 0 with a checkpoint
    every 50 steps).  Each run's mean nll over steps 80-99 must lie below
    its mean over steps 0-19, and averaged over the seeds within 25% of
    the JAX launcher's on the CPU averaged over as many seeds (one run
    moves with its draws).  Then a run killed after step 60 and
    restarted from its step-50 checkpoint must end on the uninterrupted
    run's parameters and moments bit for bit."""
    import shutil

    import torch

    arch, shape = lm_learn_arch()
    root = os.path.join(ROOT, "build", "train_lm_learn")
    shutil.rmtree(root, ignore_errors=True)
    means = []
    with no_kernel_launches("lm-smoke learn"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for seed in range(LM_LEARN_SEEDS):
            state, nll, _ = example_run(
                arch, shape, "cuda", LM_LEARN_STEPS,
                os.path.join(root, "full") if seed == 0 else None, seed=seed, metric="nll")
            traj = [nll[i] for i in range(LM_LEARN_STEPS)]
            means.append((sum(traj[:20]) / 20, sum(traj[-20:]) / 20))
            if seed == 0:
                full = state
                log(f"train[lm-smoke learn]: seed 0 nll every 10th step "
                    f"{[round(traj[i], 4) for i in range(0, LM_LEARN_STEPS, 10)]}")
            else:
                del state
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = os.path.join(root, "killed")
        _, part, _ = example_run(arch, shape, "cuda", LM_LEARN_STEPS, d,
                                 kill_after=LM_LEARN_KILL, metric="nll")
        resumed, rest, start = example_run(arch, shape, "cuda", LM_LEARN_STEPS, d,
                                           metric="nll")
    first = sum(m[0] for m in means) / len(means)
    last = sum(m[1] for m in means) / len(means)
    j_first, j_last = LM_LEARN_JAX
    log(f"train[lm-smoke learn]: {LM_LEARN_SEEDS} runs of {LM_LEARN_STEPS} steps of "
        f"{shape.global_batch} x {shape.seq_len} tokens in {wall:.1f}s "
        f"({wall / LM_LEARN_SEEDS / LM_LEARN_STEPS * 1e3:.1f} ms a step); mean nll over steps "
        f"0-19 / 80-99 by seed {[(round(a, 4), round(b, 4)) for a, b in means]}, averaged "
        f"{first:.4f} / {last:.4f}; the JAX launcher on the CPU averaged over as many seeds "
        f"{j_first:.4f} / {j_last:.4f}; {CARD}")
    tensors = lambda st: ([p.detach() for p in st.params.parameters()]
                          + list(st.opt.mu) + list(st.opt.nu))
    bitwise = all(bits_equal(a, b) for a, b in zip(tensors(resumed), tensors(full)))
    checks = {
        "every run's nll falls: mean 80-99 below mean 0-19": all(b < a for a, b in means),
        f"mean 80-99 averaged over seeds {last:.4f} within {LM_LEARN_TO_JAX:.0%} of the JAX "
        f"launcher's {j_last:.4f} ({last / j_last - 1:+.1%})":
            abs(last / j_last - 1) <= LM_LEARN_TO_JAX,
        f"killed after step {max(part) + 1}, resumed from step {start} (want 50), ran "
        f"steps {min(rest)}-{max(rest)}": start == 50 and min(rest) == 50
            and max(rest) == LM_LEARN_STEPS - 1,
        "resumed parameters and AdamW moments bit-equal to the uninterrupted run's": bitwise}
    report("lm-smoke learn", checks, kind="train")
    shutil.rmtree(root, ignore_errors=True)
    return {"first20": first, "last20": last, "by_seed": means, "bit_equal": bitwise}


def lm_train_phases():
    """8j: the LM family's training cells, each with every launch counter
    set to 0 first: gemma3-4b's gradients card against CPU, gemma3-4b
    through the launcher (full width, the deepest that fits of 34
    layers) with its profile, qwen2-moe-a2.7b at 4 layers, and the smoke
    gemma3-4b's learning and resume."""
    import gc

    import torch
    from repro_torch.core import patterns

    held = torch.cuda.memory_allocated() / 2**30
    patterns.clear_plans()  # the pattern policies' stored plans (up to 8 GiB)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train[lm]: {held:.2f} GiB held by earlier phases, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after dropping the stored "
        f"pattern plans")
    out = {"gemma3-4b grads": lm_train_grads_phase()}
    out["gemma3-4b"] = lm_train_gemma()
    out["qwen2-moe-a2.7b"] = lm_train_moe()
    out["lm-smoke learn"] = lm_learn_phase()
    return out



# ---------------------------------------------------------------------------
# 8m. the model axis in training (slices 23 and 24): the LM, DiT and vDiT
# train steps on a rank mesh of (data 1, model 2), two gloo ranks sharing
# the card
# ---------------------------------------------------------------------------

TP_RANKS = 2            # the model axis: gloo ranks on the one card
TP_LAYERS = 2           # of 34 (gemma3-4b) and 24 (qwen2-moe-a2.7b)
TP_TOKENS = (1, 1024)   # train_4k's 256 x 4096 cut to one sequence of 1024
TP_STEPS = 3
TP_REL = 1e-5           # per-step losses and final params, ranks vs one process
TP_CELLS = (("gemma3-4b", "tp"), ("qwen2-moe-a2.7b", "ep"), ("dit-xl2", "tp"),
            ("vdit-paper", "tp"))
# The diffusion cells at train_256: dit-xl2 at full size, its batch 256 cut
# to TP_DIT_BATCH in one micro-batch; vdit-paper at full width, 40 layers cut
# to TP_LAYERS, 128 frames to 32 and the batch 64 to 1: a (8, 16, 16) grid,
# 2048 + 256 text tokens.
TP_DIT_BATCH = 4
TP_VDIT = dict(num_layers=TP_LAYERS, frames=32)


def tp_arch(name):
    """``name`` at full width in float32 compute and one micro-batch: an LM
    at ``TP_LAYERS`` layers and ``TP_TOKENS`` (the MoE at a capacity that
    drops no slot, ``EP_NO_DROP``, so EP and the one process's dense MoE
    compute the same function); dit-xl2 and vdit-paper cut as above."""
    from repro_torch.configs import get_config

    arch = get_config(name)
    if arch.family == "lm":
        m = dataclasses.replace(arch.model, num_layers=TP_LAYERS)
        if m.moe is not None:
            m = dataclasses.replace(m, moe=dataclasses.replace(
                m.moe, capacity_factor=EP_NO_DROP))
        shape = dataclasses.replace(arch.shape("train_4k"), global_batch=TP_TOKENS[0],
                                    seq_len=TP_TOKENS[1])
    else:
        m = (dataclasses.replace(arch.model, **TP_VDIT) if arch.family == "vdit"
             else arch.model)
        shape = dataclasses.replace(arch.shape("train_256"), batch=(
            1 if arch.family == "vdit" else TP_DIT_BATCH))
    return dataclasses.replace(arch, model=m, shapes=(shape,),
                               train=dataclasses.replace(
                                   arch.train, compute_dtype="float32", grad_accum=1))


def tp_worker(out, name, rank, port):
    """``chip_smoke.py --tp-worker OUT NAME RANK PORT``: ``TP_STEPS`` AdamW
    steps of :func:`tp_arch`, drawn on the card from seed 0 (a diffusion
    model with every leaf random, so no adaLN gate is zero), through
    ``workloads.train_step`` on the card,
    as one process (RANK -1: it writes its final params to OUT.pt) or as
    rank RANK of a gloo group of ``TP_RANKS`` on a rank mesh of (data 1,
    model ``TP_RANKS``) (it holds its pieces against OUT's one-process
    params).  The launch counters set to 0 just before the steps and read
    just after, and the adaLN kernel's plain version counted on the card
    (:func:`plain_guard`); the model axis's collectives counted
    (``distributed.tensor_parallel``); writes OUT.json."""
    import json
    import math
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from repro_torch.data.synthetic import DataSpec
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.adaln import ops as adaln_ops
    from repro_torch.launch import workloads
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.params import init_model
    from repro_torch.training import train_loop

    rank = int(rank)
    torch.cuda.set_device(0)
    mesh = None
    t0 = time.perf_counter()
    if rank >= 0:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=TP_RANKS, rank=rank,
                                timeout=timedelta(seconds=300))
        mesh = make_rank_mesh(model_axis=TP_RANKS, device="cuda")
    arch = tp_arch(name)
    shape = arch.shapes[0]
    # Drawn on the card from the seed (the one process and every rank draw
    # the same weights; a CPU draw took 15-22 s a process).
    model = init_model(arch.model, seed=0, device="cuda", dtype=torch.float32,
                       zero_init=arch.family == "lm")
    names = [n for n, _ in model.named_parameters()]
    step = workloads.train_step(arch, shape, model, mesh=mesh)
    state = train_loop.train_state_init(model, arch.train, mesh=mesh)
    init_s = time.perf_counter() - t0
    batches = make_batch_fn(arch, shape, torch.device("cuda"))
    moved = {"calls": 0, "bytes": 0.0, "wire": 0.0, "s": 0.0}

    def counted(kind):
        def wrap(orig):
            def f(x, group, *a):
                n = dist.get_world_size(group)
                t = time.perf_counter()
                y = orig(x, group, *a)
                moved["s"] += time.perf_counter() - t
                moved["calls"] += 1
                size = x.numel() * x.element_size()
                moved["bytes"] += size
                # ring bytes on the wire a rank, as the dry run counts them
                moved["wire"] += {"all-reduce": 2 * size * (n - 1) / n,
                                  "all-gather": size * (n - 1),
                                  "reduce-scatter": size * (n - 1) / n}[kind]
                return y
            return f
        return wrap

    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    with wrapped(tpl, "all_reduce_", counted("all-reduce")), \
            wrapped(tpl, "all_gather_dim", counted("all-gather")), \
            wrapped(tpl, "reduce_scatter_dim", counted("reduce-scatter")), \
            plain_guard(((adaln_ops, "adaln_modulate_ref"),)) as plain:
        for i in range(TP_STEPS):
            batch = batches(DataSpec(seed=0), i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch, 0)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = (state.shards.local if state.shards is not None
              else list(model.parameters()))
    err = None
    if mesh is None:
        torch.save({n: p.detach().cpu() for n, p in zip(names, params)},
                   out + ".pt")
    else:
        # Held on the host in f64: the card is shared with the other rank and
        # the main process, and a f64 copy of gemma3-4b's embed piece is 2.7 GB.
        whole = torch.load(out.rsplit("-", 1)[0] + "-plain.pt", mmap=True)
        num = den = 0.0
        with torch.no_grad():
            for i, (n, p) in enumerate(zip(names, params)):
                want = state.shards.piece(whole[n], i).double()
                num += float(torch.sum((p.detach().cpu().double() - want) ** 2))
                den += float(torch.sum(want ** 2))
        err = (num / den) ** 0.5
    sh = state.shards
    rec = {"losses": losses, "ms": ms, "peak_gib": peak, "init_s": init_s,
           "launches": counts, "plain": plain, "param_rel": err, "moved": moved,
           "params": sum(p.numel() for p in params),
           # what the rule tables give a rank: each parameter whole, or its
           # piece on the model axis
           "pieces": sum(math.prod(s) // (1 if md is None else TP_RANKS)
                         for s, md in zip(sh.shapes, sh.mdims)) if sh else None,
           "backend": dist.get_backend() if mesh else None,
           "mesh": mesh.shape if mesh else None}
    with open(out + ".json", "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1)
    if mesh is not None:
        dist.barrier()
        dist.destroy_process_group()
    return 0


def tp_spawn(label, name, ranks):
    """Run ``--tp-worker`` for ``name`` as one process (``ranks`` 0) or as
    ``ranks`` gloo ranks; every process must exit 0 (a failed rank fails
    the phase: nothing falls back to one process).  Returns (wall seconds,
    the records)."""
    import json
    import socket

    import torch

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    tag = "plain" if ranks == 0 else "rank"
    outs = [os.path.join(DIST_DIR, f"tp-{name}-{tag}{r}" if ranks else
                         f"tp-{name}-plain") for r in range(max(ranks, 1))]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS=str(max(1, torch.get_num_threads() // TP_RANKS)),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-worker",
                               o, name, str(r if ranks else -1), str(port)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r, o in enumerate(outs)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            lines = text.strip().splitlines()
            raise RuntimeError(f"dist[{label}]: {tag} {r} exit {p.returncode}: "
                               + " | ".join(lines[-30:]))
    recs = []
    for o in outs:
        with open(o + ".json", encoding="utf-8") as f:
            recs.append(json.load(f))
    return wall, recs


# 8m's waves, each a set of runs side by side ((cell, ranks); 0 ranks is the
# one process): the LMs' one processes (24.88 + 29.38 GiB at their peaks),
# then one cell's ranks at a time, the diffusion cells' one processes beside
# gemma3-4b's ranks.  Each process's card memory is its own and the main
# process keeps its own beside them: one cell's ranks beside the other LM's
# one process, each rank holding a f64 copy of its pieces on the card for
# its check, ran out of the card's memory.
TP_WAVES = ((("gemma3-4b", 0), ("qwen2-moe-a2.7b", 0)),
            (("gemma3-4b", TP_RANKS), ("dit-xl2", 0), ("vdit-paper", 0)),
            (("qwen2-moe-a2.7b", TP_RANKS),), (("dit-xl2", TP_RANKS),),
            (("vdit-paper", TP_RANKS),))


def tp_phases_start():
    """Start 8m on a thread of its own, ``TP_WAVES`` one after another.
    The main thread carries on with checks that time nothing;
    :func:`tp_phases_finish` joins it."""
    import threading

    import torch

    os.makedirs(DIST_DIR, exist_ok=True)
    torch.cuda.empty_cache()  # the main process's cached blocks
    held = (torch.cuda.memory_allocated() / 2**30, torch.cuda.memory_reserved() / 2**30)
    res = {}

    def spawn(name, kind, ranks):
        res[name if ranks else f"{name} plain"] = tp_spawn(
            f"train {name} {kind}", name, ranks)

    kinds = dict(TP_CELLS)

    def run():
        try:
            t0 = time.perf_counter()
            for wave in TP_WAVES:
                errors = []
                runs = [threading.Thread(target=_catching,
                                         args=(errors, spawn, name, kinds[name], ranks))
                        for name, ranks in wave]
                for th in runs:
                    th.start()
                for th in runs:
                    th.join()
                if errors:
                    raise RuntimeError(errors[0])
            res["wall"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — reported by tp_phases_finish
            res["error"] = repr(e)

    th = threading.Thread(target=run)
    th.start()
    log(f"dist[train tp/ep]: started: {TP_RANKS} gloo ranks on the card at (data 1, "
        f"model {TP_RANKS}) and one process each, chip_smoke.py --tp-worker: "
        f"{', '.join(n for n, _ in TP_CELLS)} at full width (the LMs {TP_LAYERS} layers, "
        f"{TP_TOKENS[0]} x {TP_TOKENS[1]} tokens; dit-xl2 all 28 layers, {TP_DIT_BATCH} "
        f"images of 256 tokens; vdit-paper {TP_LAYERS} layers, 2048 + 256 tokens), f32, "
        f"{TP_STEPS} AdamW steps; the main process holds {held[0]:.2f} GiB allocated, "
        f"{held[1]:.2f} GiB reserved")
    return th, res


def _catching(errors, fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 — re-raised by the caller
        errors.append(repr(e))


def tp_phases_finish(started):
    """8m's checks, once its thread is done: for each cell every rank's
    per-step losses within ``TP_REL`` of the one process's, its final
    pieces within ``TP_REL`` of the one process's params (relative L2),
    the pieces the rule tables give it, a gloo group on the (1, TP_RANKS)
    mesh; no kernel launch on an LM's path; on the DiT's each rank's adaLN
    launches the one process's, 2 a block and the final one a forward,
    and no other kernel's; the adaLN kernel's plain version never called
    on the card; each rank's ms a step, peak memory and the model axis's
    bytes.  Returns {cell: the launches of its rank 0}."""
    th, res = started
    th.join()
    if "error" in res:
        raise SystemExit(res["error"])
    log(f"dist[train tp/ep]: {res['wall']:.1f}s wall for the {len(TP_CELLS)} cells with "
        f"the processes' start and the models' init")
    out = {}
    for name, kind in TP_CELLS:
        label = f"train {name} {kind}"
        (pwall, (plain,)), (wall, ranks) = res[f"{name} plain"], res[name]
        log(f"dist[{label}]: one process: losses {plain['losses']}, "
            f"{', '.join(f'{x:.1f}' for x in plain['ms'])} ms a step, peak "
            f"{plain['peak_gib']:.2f} GiB, {plain['params'] / 1e9:.3f} B params, "
            f"{pwall:.1f}s with its start ({plain['init_s']:.1f}s init); {CARD}")
        for r, g in enumerate(ranks):
            mv = g["moved"]
            log(f"dist[{label}]: rank {r} of {g['mesh']}: losses {g['losses']}, "
                f"{', '.join(f'{x:.1f}' for x in g['ms'])} ms a step, peak "
                f"{g['peak_gib']:.2f} GiB, {g['params'] / 1e9:.3f} B params held; the "
                f"model axis moved {mv['bytes'] / 1e9:.3f} GB in {mv['calls']} "
                f"collectives ({mv['wire'] / 1e9:.3f} GB ring bytes on the wire, "
                f"{mv['s']:.2f}s host wall through pinned memory and gloo); final "
                f"params rel L2 {g['param_rel']:.3e}; {CARD}")
        log(f"dist[{label}]: {wall:.1f}s for the ranks with their start "
            f"({max(g['init_s'] for g in ranks):.1f}s init); NCCL between cards: "
            f"not measured (one card cannot host two NCCL ranks)")
        rel = max(abs(a - b) / abs(b) for g in ranks
                  for a, b in zip(g["losses"], plain["losses"]))
        held = ", ".join(f"{g['params'] / plain['params']:.3f}" for g in ranks)
        checks = {
            f"a gloo group of {TP_RANKS} ranks on a (data 1, model {TP_RANKS}) mesh":
                all(g["backend"] == "gloo" and g["mesh"] == {"data": 1, "model": TP_RANKS}
                    for g in ranks),
            f"per-step losses within {TP_REL} of one process ({rel:.3e})":
                rel <= TP_REL and all(len(g["losses"]) == TP_STEPS for g in ranks),
            f"final params within {TP_REL} of one process": all(
                g["param_rel"] <= TP_REL for g in ranks),
            f"each rank holds its pieces by the rule tables ({held} of the params)":
                all(g["params"] == g["pieces"] < plain["params"] for g in ranks),
            "the model axis moved bytes": all(g["moved"]["calls"] > 0 for g in ranks),
            "the adaLN kernel's plain version never ran on the card": not any(
                v for g in [plain, *ranks] for v in g["plain"].values()),
        }
        arch = tp_arch(name)
        if arch.family == "lm":
            checks["each rank holds about half the params"] = all(
                0.45 <= g["params"] / plain["params"] <= 0.55 for g in ranks)
        want = {k: 0 for k in plain["launches"]}
        if arch.family == "dit":
            want["adaln"] = (2 * arch.model.num_layers + 1) * TP_STEPS
        checks["no kernel of the port launched" if not any(want.values()) else
               f"each process launched adaLN {want.get('adaln')} times (2 a block and "
               f"the final one, a forward) and no other kernel"] = all(
            g["launches"] == want for g in [plain, *ranks])
        report(label, checks, kind="dist")
        out[name] = ranks[0]["launches"]
    return out


# ---------------------------------------------------------------------------
# 8k. the launch tools (slice 21): the dry run's counts against the card
# ---------------------------------------------------------------------------

# The dry run (``repro_torch.launch.dryrun``) counts one rank's step on fake
# tensors with the H100's constants.  Host processes started after the
# build (``--dryrun-worker``, one a cell, CUDA hidden from them, at a lower
# priority) count train[dit-xl2]'s configuration, train[gemma3-4b]'s at the
# first two depths it tries and one serve[dit-xl2] forward while the card
# runs its phases; 8k, last, holds each count against what those phases
# measured.
DRYRUN_GEMMA_DEPTHS = LM_TRAIN_DEPTHS[:2]
DRYRUN_PEAK_BAR = 0.10     # predicted peak against the run's own, relative
DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun")
DRYRUN_WAIT_S = 300        # the longest 8k waits for the host processes


def lm_train_arch(name, layers):
    """The arch ``repro_torch.launch.train`` trains under
    :func:`lm_train_argv`: ``layers`` layers, train_4k's global batch cut to
    LM_TRAIN_BATCH."""
    from repro_torch.config.base import apply_overrides
    from repro_torch.configs import get_config

    arch = apply_overrides(get_config(name), (f"model.num_layers={layers}",))
    shape = dataclasses.replace(arch.shape("train_4k"), global_batch=LM_TRAIN_BATCH)
    return dataclasses.replace(arch, shapes=tuple(
        shape if s.name == shape.name else s for s in arch.shapes))


def dryrun_cells():
    """label -> (arch, shape name) of each cell the host processes count."""
    from repro_torch.configs import get_config

    dit = get_config("dit-xl2")
    cells = {"train dit-xl2": (dit, "train_256"), "generate dit-xl2": (dit, DIT_SHAPE)}
    for layers in DRYRUN_GEMMA_DEPTHS:
        cells[f"train gemma3-4b {layers}"] = (lm_train_arch("gemma3-4b", layers), "train_4k")
    return cells


def dryrun_worker(out, label):
    """``chip_smoke.py --dryrun-worker OUT LABEL``: the cell ``label`` of
    :func:`dryrun_cells` counted by the dry run on the host, its row
    written to OUT as JSON."""
    from repro_torch.launch.dryrun import run_cell

    os.nice(10)  # the card's phases are host-paced: they come first
    arch, shape = dryrun_cells()[label]
    row = run_cell(arch.name, shape, arch=arch, verbose=False).row()
    with open(out, "w", encoding="utf-8") as f:
        json.dump(row, f, indent=1)
    return 0


def dryrun_start():
    """Start :func:`dryrun_worker` for each cell, a process each, CUDA
    hidden from them and one CPU thread each; they are killed at exit if
    still running.  Returns {label: (process, its JSON path)} and the
    start time."""
    import atexit
    import shutil

    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    os.makedirs(DRYRUN_OUT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = {}
    for i, label in enumerate(dryrun_cells()):
        out = os.path.join(DRYRUN_OUT, f"cell{i}.json")
        with open(os.path.join(DRYRUN_OUT, f"cell{i}.log"), "w", encoding="utf-8") as logf:
            procs[label] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dryrun-worker", out, label],
                env=env, cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT), out)
    atexit.register(lambda: [p.kill() for p, _ in procs.values() if p.poll() is None])
    log(f"dryrun: counting {list(procs)} on the host, a process each")
    return procs, time.perf_counter()


def dryrun_rows(dryrun):
    """The host processes' rows, once they have ended."""
    procs, t0 = dryrun
    rows, deadline = {}, time.perf_counter() + DRYRUN_WAIT_S
    for label, (proc, out) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            for p, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            with open(out[:-len(".json")] + ".log", encoding="utf-8") as f:
                log(f.read()[-3000:])
            raise SystemExit(f"dryrun: the host process of {label} "
                             f"{'failed (rc %s)' % rc if rc is not None else 'did not end'}")
        with open(out, encoding="utf-8") as f:
            rows[label] = json.load(f)
    log(f"dryrun: the host processes ended within {time.perf_counter() - t0:.1f}s of their start "
        f"(8k waited {time.perf_counter() - deadline + DRYRUN_WAIT_S:.1f}s)")
    return rows


def dryrun_train(label, row, run):
    """dryrun[label]: a train cell's predicted per-rank peak against the
    run's own (its peak less what earlier phases held), and its bound
    against the run's ms a step; the ratio of the two and the share of the
    bf16 peak that the step's model FLOPs reach."""
    from repro_torch.launch import roofline

    pred = row["peak_mem_gb"] * 1e9 / 2**30
    own = run["own_peak_gib"]
    bound_ms = row["bound_s"] * 1e3
    ms = run["ms"]
    share = row["model_flops"] / (ms / 1e3) / roofline.PEAK_FLOPS["bfloat16"]
    log(f"dryrun[{label}]: predicted peak {pred:.2f} GiB against the run's own "
        f"{own:.2f} GiB ({pred / own - 1:+.2%}); bound {bound_ms:.3f} ms "
        f"(compute {row['compute_s'] * 1e3:.3f}, memory {row['memory_s'] * 1e3:.3f} ms: "
        f"{row['hlo_flops']:.4e} FLOP, {row['hlo_bytes']:.4e} bytes; {row['dominant']}) "
        f"against {ms:.3f} ms a "
        f"step: {bound_ms / ms:.3f} of it; model FLOPs {row['model_flops']:.4e} reach "
        f"{share:.4f} of the bf16 peak; kernel calls {row['kernel_calls']}; {CARD}")
    report(label, {f"predicted peak within {DRYRUN_PEAK_BAR:.0%} of the run's own":
                   abs(pred / own - 1) <= DRYRUN_PEAK_BAR,
                   "the bound does not exceed the measured step": bound_ms <= ms},
           kind="dryrun")
    return {"pred_peak_gib": pred, "own_peak_gib": own, "bound_ms": bound_ms, "ms": ms,
            "bound_share": bound_ms / ms, "model_flops_share": share}


def dryrun_phases(dryrun, train_out, lm_out, counts_d, prof_d, steps_d):
    """8k: dryrun[train dit-xl2], dryrun[train gemma3-4b] at the depth
    train[gemma3-4b] ran (with the predicted peaks at each depth of
    DRYRUN_GEMMA_DEPTHS beside the card's memory) and dryrun[generate
    dit-xl2]: its counted kernel calls equal to serve[dit-xl2]'s launches a
    forward, its bound within profile[dit-xl2]'s device busy time."""
    import torch
    from repro_torch.launch.dryrun import run_cell

    rows = dryrun_rows(dryrun)
    out = {"train dit-xl2": dryrun_train("train dit-xl2", rows["train dit-xl2"],
                                         train_out["dit-xl2"])}
    gemma = lm_out["gemma3-4b"]
    layers = gemma["layers"]
    key = f"train gemma3-4b {layers}"
    if key not in rows:  # a depth the host process did not count
        rows[key] = run_cell("gemma3-4b", "train_4k", arch=lm_train_arch("gemma3-4b", layers),
                             verbose=False).row()
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    log("dryrun[train gemma3-4b]: predicted peaks " + ", ".join(
        f"{d} layers {rows[f'train gemma3-4b {d}']['peak_mem_gb'] * 1e9 / 2**30:.2f} GiB"
        for d in DRYRUN_GEMMA_DEPTHS if f"train gemma3-4b {d}" in rows)
        + f" against the card's {card_gib:.2f} GiB; train[gemma3-4b] ran {layers} layers")
    out["train gemma3-4b"] = dryrun_train("train gemma3-4b", rows[key], gemma)
    out["train gemma3-4b"]["layers"] = layers
    row = rows["generate dit-xl2"]
    per_forward = {k: v // steps_d for k, v in counts_d.items() if v}
    whole = all(v % steps_d == 0 for v in counts_d.values())
    bound_ms, busy = row["bound_s"] * 1e3, prof_d["busy"]
    log(f"dryrun[generate dit-xl2]: one denoiser forward at batch {DIT_REQUESTS}: kernel "
        f"calls {row['kernel_calls']} against serve[dit-xl2]'s launches a forward "
        f"{per_forward} ({counts_d} in {steps_d} steps); bound {bound_ms:.3f} ms (compute "
        f"{row['compute_s'] * 1e3:.3f}, memory {row['memory_s'] * 1e3:.3f}) against "
        f"profile[dit-xl2]'s device busy {busy:.3f} ms: {bound_ms / busy:.3f} of it; {CARD}")
    report("generate dit-xl2", {
        "the counted kernel calls equal the card's launches a forward":
            whole and row["kernel_calls"] == per_forward,
        "the bound does not exceed the device busy time": bound_ms <= busy},
        kind="dryrun")
    out["generate dit-xl2"] = {"kernel_calls": row["kernel_calls"], "bound_ms": bound_ms,
                               "busy_ms": busy}
    return out

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=40,
                    help="served depth (the full model has 40)")
    ap.add_argument("--baseline", metavar="DIR",
                    help="only time the snap step of the checkout at DIR against "
                         "this one's, in turns (see snap_ab)")
    ap.add_argument("--snap-times", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--train-worker", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)  # OUT ARGV...: dist[train ...]'s child
    ap.add_argument("--dryrun-worker", nargs=2, metavar=("OUT", "LABEL"),
                    help=argparse.SUPPRESS)  # a dryrun[...] cell's host process
    ap.add_argument("--serve-mesh-worker", nargs=3, metavar=("OUT", "RANK", "PORT"),
                    help=argparse.SUPPRESS)  # a rank of dist[serve mesh]
    ap.add_argument("--tp-worker", nargs=4, metavar=("OUT", "NAME", "RANK", "PORT"),
                    help=argparse.SUPPRESS)  # a process of dist[train ... tp/ep]
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 2
    src = args.snap_times or os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    if args.dryrun_worker:  # on the host only: CUDA is hidden from it
        return dryrun_worker(*args.dryrun_worker)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # The pattern policies read only artifacts this run writes or installs.
    os.environ["REPRO_PATTERN_ARTIFACT"] = os.path.join(PATTERN_DIR, "active.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Serving and the kernel checks build no autograd graph; the training
    # phases take gradients with grad mode on where they need it.
    torch.set_grad_enabled(False)
    if args.train_worker:
        return train_worker(args.train_worker[0], args.train_worker[1:])
    if args.serve_mesh_worker:
        return serve_mesh_worker(*args.serve_mesh_worker)
    if args.tp_worker:
        return tp_worker(*args.tp_worker)

    global CARD
    card = CARD = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    if args.snap_times:
        snap_times(args.layers)
        return 0
    if args.baseline:
        snap_ab(args.baseline, args.layers)
        print(card, flush=True)
        return 0

    # 1. build --------------------------------------------------------------
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}; "
        f"{time.perf_counter() - t0:.1f}s wall for {len(built)} sources")
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln or "Performance Loss" in ln]
        own = " ".join(_build.SOURCE_FLAGS.get(name, ())) or "none"
        log(f"build: {name} (own flags: {own}): {info['path']} "
            f"({info['seconds']:.1f}s) {' | '.join(regs)}")
    # The dry run's cells, counted on the host while the card runs (8k).
    dryrun = dryrun_start()

    from repro_torch.kernels.reuse_mask import ops as reuse_ops
    from repro_torch.kernels.ripple import ops as ripple_ops
    from repro_torch.kernels.ripple.ref import ripple_attention_ref

    bf16, f32 = torch.bfloat16, torch.float32
    serve_grid = (8, 32, 32)
    n_grid = 8 * 32 * 32

    # 2. kernel 1 vs its plain version --------------------------------------
    dit_grid = (1, 64, 64)
    dit_qk = (DIT_REQUESTS, 16, 64 * 64, 72)
    serve_err1 = reuse_checks(serve_grid, dit_qk, dit_grid)
    source_map_checks(serve_grid, dit_qk, dit_grid)

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
    # B*H > 1 at a pair count (209) that is a multiple of neither 32 nor
    # the 64-pair key stage: a ragged tile must not read the next head.
    # Then all-collapsed keys under dense queries, and the other way round.
    for d in (128, 72):
        for fq, fk in ((0.6, 0.6), (1.0, 1.0), (0.0, 1.0), (1.0, 0.0)):
            q = snapped_operand((2, 3, 418, d), fq, 24, bf16, tile)
            k = snapped_operand((2, 3, 418, d), fk, 25, bf16, tile)
            v = snapped_operand((2, 3, 418, d), 0.0, 26, bf16, tile)
            check_ripple(res2, q, k, v, f"(2, 3, 418, {d}) q frac={fq} k frac={fk} "
                         f"(ragged, B*H > 1)")
    n_tok = n_grid + 256
    serve_qkv = (1, 24, n_tok, 128)
    q = snapped_operand(serve_qkv, 0.6, 7, bf16, tile)
    k = snapped_operand(serve_qkv, 0.6, 8, bf16, tile)
    v = snapped_operand(serve_qkv, 0.0, 9, bf16, tile)
    check_ripple(res2, q, k, v, f"N={n_tok} d=128 frac=0.6 (serving shape)")
    # Serving-shape operands as the main path makes them: text tokens
    # first, then grid tokens snapped by kernel 1 at θ = 0.2.
    qk = [reuse_ops.fused_compute_reuse(
        correlated(serve_qkv, bf16, seed), serve_grid, dict(zip("txy", (0.2,) * 3)),
        grid_slice=(256, n_grid))[0] for seed in (10, 11)]
    v = correlated(serve_qkv, bf16, 12)
    serve_err = check_ripple(res2, qk[0], qk[1], v,
                             f"N={n_tok} d=128 main-path snapped operands")
    # serve[launcher]'s half-resolution bucket, constructed and as the
    # main path makes it: (2, 24, 2304, 128), grid slice (256, 2048).
    half_qkv = (HALF_SNAP[0], HALF_SNAP[1], SERVE_TEXT[0] + HALF_SNAP[2], 128)
    check_ripple(res2, *(snapped_operand(half_qkv, frac, seed, bf16, tile)
                         for frac, seed in ((0.6, 27), (0.6, 28), (0.0, 29))),
                 f"{half_qkv} frac=0.6 (serve[launcher] half resolution)")
    half_q, half_k = (reuse_ops.fused_compute_reuse(
        correlated(half_qkv, bf16, seed), HALF_GRID, dict(zip("txy", (0.2,) * 3)),
        grid_slice=(SERVE_TEXT[0], HALF_SNAP[2]))[0] for seed in (31, 32))
    check_ripple(res2, half_q, half_k, correlated(half_qkv, bf16, 33),
                 f"{half_qkv} main-path snapped operands (serve[launcher] half "
                 f"resolution)")
    del half_q, half_k
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
    unet_served = unet_ripple_checks(res2)
    log(f"kernel ripple_attention: {sum(res2)}/{len(res2)} cases within "
        f"tolerance")

    # 4. kernel 4 (adaLN) vs its plain version -------------------------------
    adaln_err = adaln_checks()

    # 5. kernel 3 vs its plain semantics -------------------------------------
    sparse_checks(serve_grid, 256)
    res_u = []
    unet_sparse = unet_sparse_checks(res_u)
    log(f"kernel sparse_attention at unet-sd15's head dims: {sum(res_u)}/{len(res_u)} "
        f"cases within tolerance")
    # 5a. the carry, and ring attention on the one card (slice 15)
    carry_times, ring_launches, ring_bench = mesh_phases()

    # 5b. kernels 5 (flash) and 6 (reuse_snap) vs their plain versions ------
    fl256_err = flash_checks()
    snap_err = snap_checks()

    # 6. times at the serving shapes (bf16) ---------------------------------
    flush = l2_flush()
    x1 = reuse_operand(SERVE_SNAP, bf16, 20, 0.6, text=SERVE_TEXT)
    t1 = time_fused_reuse(x1, serve_grid, ("t", "x", "y"), (SERVE_TEXT[0], SERVE_SNAP[2]),
                          "vDiT served call", flush)
    t1s = time_fused_reuse(x1, serve_grid, ("t", "x", "y"), (SERVE_TEXT[0], SERVE_SNAP[2]),
                           "vDiT served call, a refresh step", flush, want_src=True)
    del x1

    q, k = qk
    k2_ms = cuda_time_ms(lambda: ripple_ops.ripple_attention(q, k, v), iters=5)
    scale = ripple_ops.attention_scale(128)
    k2_plain = cuda_time_ms(lambda: ripple_attention_ref(q, k, v, scale), iters=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k2_lib = cuda_time_ms(lambda: sdpa(q, k, v, scale=scale), iters=10)
    k2_bound, k2_by, flops, _, _ = ripple_bound(q, k, 128)
    k2_by = "bytes" if k2_by == "bytes" else "operations"
    log(f"time ripple_attention bf16 {tuple(serve_qkv)}: kernel {k2_ms:.4f} ms "
        f"({flops / k2_ms / 1e9:.2f} TFLOP/s), plain {k2_plain:.4f} ms, sdpa "
        f"{k2_lib:.4f} ms, bound {k2_bound:.4f} ms ({k2_by}: {flops / 1e12:.4f} "
        f"TFLOP); kernel/sdpa {k2_ms / k2_lib:.3f}, bound/kernel {k2_bound / k2_ms:.3f}")
    del q, k, v, qk

    xd = correlated(dit_qk, bf16, 22)
    time_fused_reuse(xd, dit_grid, ("x", "y"), None, "dit-xl2 served call", flush)
    del xd

    q, k, v = dit_q, dit_k, dit_v
    r_ms = cuda_time_ms(lambda: ripple_ops.ripple_attention(q, k, v), iters=5)
    scale = ripple_ops.attention_scale(72)
    r_plain = cuda_time_ms(lambda: ripple_attention_ref(q, k, v, scale), iters=3)
    r_lib = cuda_time_ms(lambda: sdpa(q, k, v, scale=scale), iters=10)
    r_bound, r_by, r_flops, _, _ = ripple_bound(q, k, 72)
    log(f"time ripple_attention bf16 {dit_qk} (dit-xl2, tensor cores "
        f"{ripple_ops.uses_tensor_cores(q, v)}): kernel {r_ms:.4f} ms "
        f"({r_flops / r_ms / 1e9:.2f} TFLOP/s), plain {r_plain:.4f} ms, sdpa "
        f"{r_lib:.4f} ms, bound {r_bound:.4f} ms ({r_by}: {r_flops / 1e12:.4f} "
        f"TFLOP); kernel/sdpa {r_ms / r_lib:.3f}, bound/kernel {r_bound / r_ms:.3f}")
    del q, k, v, dit_q, dit_k, dit_v
    unet_times = time_unet_ripple(unet_served)
    unet_sparse_times = time_unet_sparse(unet_sparse)
    del unet_served, unet_sparse  # frees their operands and maps on the card
    xu = correlated(UNET_QK[0][0], bf16, 24)
    t1u = time_fused_reuse(xu, UNET_QK[0][1], ("x", "y"), None, "unet-sd15 served call",
                           flush)
    del xu
    # reuse[flux]: both kernels at flux-dev's served joint-attention call.
    t1f, flux_ripple = flux_kernel_phase(flush)
    # reuse[vit]: fused_reuse at vit-l16's call, 197 tokens (slice 16).
    t1v = vit_kernel_phase(flush)

    # adaLN at the DiT's main-path shape, shift/scale chunks of the
    # projection as the model passes them.
    from repro_torch.kernels.adaln.ops import adaln_modulate
    from repro_torch.kernels.adaln.ref import adaln_modulate_ref
    from repro_torch.launch import roofline

    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    xa = torch.randn((DIT_REQUESTS, 4096, 1152), generator=g, device="cuda").to(bf16)
    ada = torch.randn((DIT_REQUESTS, 6 * 1152), generator=g, device="cuda").to(bf16)
    sha, sca = torch.chunk(ada, 6, dim=-1)[:2]
    a_ms, a_host = device_time_ms(lambda: adaln_modulate(xa, sha, sca), "adaln_kernel",
                                  flush=flush)
    a_wrap = cuda_time_ms(lambda: adaln_modulate(xa, sha, sca), iters=20)
    # The wrapper's host cost served (a direct launch) against training (x
    # requires grad: the autograd Function), in alternating rounds.
    xg = xa.detach().requires_grad_(True)

    def train_call():
        with torch.enable_grad():
            adaln_modulate(xg, sha, sca)

    a_host_ab = host_ab_ms([lambda: adaln_modulate(xa, sha, sca), train_call])
    a_plain = cuda_time_ms(lambda: adaln_modulate_ref(xa, sha, sca), iters=10)
    layer_norm = torch.nn.functional.layer_norm
    a_lib = cuda_time_ms(lambda: layer_norm(xa, (1152,), eps=1e-6)
                         * (1 + sca[:, None]) + sha[:, None], iters=20)
    a_work = roofline.adaln_work(xa.shape, xa.element_size())
    a_bound, a_by = a_work.bound()
    a_bytes = a_work.nbytes
    log(f"time adaln bf16 {tuple(xa.shape)}: device {a_ms:.4f} ms a call (L2 flushed; "
        f"{a_bytes / a_ms / 1e6:.1f} GB/s, {a_bound / a_ms:.3f} of the bound), host "
        f"{a_host:.4f} ms a wrapper call (alternating rounds: served {a_host_ab[0]:.4f}, "
        f"through the autograd Function {a_host_ab[1]:.4f}), wrapper time back to back "
        f"{a_wrap:.4f} ms; plain {a_plain:.4f} ms, F.layer_norm and two elementwise ops {a_lib:.4f} ms "
        f"(no single PyTorch call), bound {a_bound:.4f} ms ({a_by}: "
        f"{a_bytes / 1e6:.1f} MB); {CARD}")
    del xa, xg, ada, sha, sca
    torch.cuda.empty_cache()
    # adaln[grad]: the kernel under autograd, against the plain version's.
    adaln_grad_err = adaln_grad_phase()
    time_flash(FLASH_SERVE_SHAPES[0], "vDiT serving shape")
    time_flash(FLASH_SERVE_SHAPES[1], "dit-xl2 serving shape")
    fl256 = time_flash(FLASH_D256_SHAPE, "gemma3-4b's global-layer head shape, unmasked: "
                       "not the LM path's call, which masks")
    sn_ms, sn_host, sn_plain, sn_bound, sn_by = time_snap(flush)
    del flush

    # 7. serving phases: each path with the launch counters set to 0 just
    # before it and read just after -------------------------------------------
    from repro_torch.config.base import apply_overrides
    from repro_torch.core.policy import get_policy
    from repro_torch.core.svg_mask import svg_logit_bias
    from repro_torch.kernels.sparse import ops as sparse_ops
    from repro_torch.kernels.sparse.ops import block_map_from_keep
    from repro_torch.kernels.sparse.ref import FULL, sparse_attention_ref

    arch, shape, model = load_served_model(args.layers)
    served_lat = {"ripple": {}, "static": {}}
    counts_r, lat_shape, _ = serve_ripple(arch, shape, model,
                                          latents=served_lat["ripple"])
    profile_forward("ripple", arch, model, lat_shape,
                    {"ripple_attention": "ripple", "fused_reuse": "fused_reuse"},
                    annotate=ripple_ranges())
    served = {}
    arch_s, model_s = depth_view(arch, model, SVG_LAYERS)
    log(f"serve[svg], serve[ripple+svg], profile[svg]: the first {len(model_s.blocks)} "
        f"of the served model's {len(model.blocks)} layers")
    counts_s = serve_svg("svg", arch_s, shape, model_s, policy="svg",
                         launched=("sparse_attention",),
                         absent=("ripple_attention", "fused_reuse"), capture=served)
    profile_forward("svg", apply_overrides(arch_s, ("ripple.policy=svg",)), model_s,
                    lat_shape, {"sparse_attention": "sparse"},
                    annotate=[(get_policy("svg"), "decide", "svg_mask")])
    serve_svg("ripple+svg", apply_overrides(arch_s, ("ripple.svg_mask=true",)), shape,
              model_s, policy=None, launched=("fused_reuse", "sparse_attention"),
              absent=("ripple_attention",))
    del model_s
    # The decision cache: ripple at CACHE_LAYERS, then svg at 2 layers (its
    # dense per-layer bias does not fit 40 layers on one card).
    cache_cut = (f"ripple.reuse_every={CACHE_EVERY}",)
    arch_c, model_c = depth_view(apply_overrides(arch, cache_cut), model, CACHE_LAYERS)
    log(f"serve[ripple-cache], profile[ripple-cache ...]: the first "
        f"{len(model_c.blocks)} of the served model's {len(model.blocks)} layers")
    counts_c, _ = serve_ripple_cache(arch_c, dataclasses.replace(shape, steps=CACHE_STEPS),
                                     model_c)
    profile_cache(arch_c, model_c, lat_shape, 12, 13, CACHE_STEPS)
    del model_c
    # The offline-pattern policies: the search at the served grid, then
    # static (no artifact) and rainfusion (the searched artifact).
    art_path = pattern_search_phase()
    counts_st = serve_static(arch, shape, model, latents=served_lat["static"])
    counts_rf = serve_rainfusion(arch, shape, model, art_path)
    # The engine and launcher of slice 11: per-request policies with the
    # artifact pinned per sampler, then the launcher's main() itself.
    counts_pol = serve_policies(arch, shape, model, art_path, served_lat)
    del model, served_lat
    torch.cuda.empty_cache()
    counts_la, launcher_done = serve_launcher()
    # The launcher again with --mesh 2x2: 4 shards on the one card.
    counts_mesh, mesh_done = serve_mesh(launcher_done)
    # The launcher again under --distributed at one rank, over NCCL (slice 20).
    dist_serve(launcher_done, counts_la)
    # --mesh 2x2 over two gloo ranks on the one card.
    dist_serve_mesh(mesh_done, counts_mesh)
    del mesh_done
    # The serving control plane on the launcher's 8-layer model (8e).
    serve_slo()
    serve_failover()
    counts_gr = serve_guardrail()
    # Crash safety (10d): the crash drill, then resume in process.
    counts_cr = serve_crash(launcher_done)
    serve_resume()
    del launcher_done
    arch2, shape2, model2 = load_served_model(2)
    serve_svg_cache(apply_overrides(arch2, cache_cut),
                    dataclasses.replace(shape2, steps=CACHE_STEPS), model2)
    del model2
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
    counts_d, prof_d, steps_d = serve_dit()

    # 8a. unet-sd15 at full width and depth, with the counters set to 0 just
    # before it and read just after ----------------------------------------
    counts_u, by_shape_u = serve_unet()
    for inst in unet_times:
        inst["launches"] = sum(c for (n, d), c in by_shape_u.items()
                               if [n, d] == inst["shape"][-2:])
    # 8a'. unet-sd15 under svg: the sparse kernel at d 40, 80 and 160.
    counts_us, by_shape_us = serve_unet_svg()
    for inst in unet_sparse_times:
        inst["launches_unet_svg"] = sum(c for (n, d), c in by_shape_us.items()
                                        if [n, d] == inst["shape"][-2:])

    # 8a''. flux-dev at full width and depth, then the launcher on it, each
    # with the counters set to 0 just before and read just after ----------
    counts_f = serve_flux()
    counts_fl = serve_flux_launcher()

    # 8g. the vision family at full width and depth: vit-l16 (ripple off
    # and on) and efficientnet-b7 classify, counters set to 0 just before
    # each run and read just after ---------------------------------------
    counts_v = classify_vit()
    classify_effnet()

    # 8h. the LM family: gemma3-4b prefill_32k and decode_32k, qwen2-moe
    # at full width and depth, qwen3-32b and phi3.5-moe at cut depth; every
    # launch counter 0 before each run and still 0 after --------------------
    lm_phases()

    # 8i. training (slice 18): the adaLN kernel's gradient through a small
    # dit-xl2, then the launcher's main on dit-xl2 (full width and depth),
    # vdit-paper (full width, cut depth), vit-l16 and efficientnet-b7, and
    # the JAX package's training example with a kill and a resume --------
    train_out = train_phases()

    # 8j. LM training (slice 19): gemma3-4b's gradients card vs CPU, the
    # launcher on gemma3-4b (train_4k, full width) and qwen2-moe-a2.7b (4
    # layers), the smoke gemma3-4b's learning and resume; no kernel launches
    lm_out = lm_train_phases()

    # 8b. the kernel micro-bench and the public pair-snap wrapper, each
    # with the counters set to 0 just before and read just after ----------
    counts_kb, (fl_err, fl_ms, fl_plain, fl_lib, fl_bound, fl_by) = kernel_bench_phase()
    counts_sn = snap_phase()

    # 8m. the model axis in training (slice 23): gemma3-4b (TP) and
    # qwen2-moe-a2.7b (TP with EP) on 2 gloo ranks of (data 1, model 2)
    # against one process each, in processes of their own beside the
    # card-vs-CPU checks of 9, which time nothing -------------------------
    tp_started = tp_phases_start()

    # 9. small trajectories, card vs CPU ------------------------------------
    small_reference_check("ripple")
    small_reference_check("svg", policy="svg")
    small_reference_check("ripple+svg", overrides=("ripple.svg_mask=true",))
    # The decision cache with the drift guard on; steps from 1 snap, so the
    # hit steps after a refresh at 2, 4, ... replay snaps.
    small_reference_check("cache", overrides=("ripple.reuse_every=2", "ripple.drift_tol=0.1",
                                              "ripple.i_min=1", "ripple.i_max=6"))
    # The DiT at head dim 72 (d_model 144, 2 heads), 2 layers, grid (1, 4, 4).
    small_reference_check("dit-xl2", name="dit-xl2",
                          overrides=("model.d_model=144", "model.num_heads=2"))
    # The smoke UNet (ch 32, 2 levels, head dims 8 and 16), latents 8 x 8.
    small_reference_check("unet", name="unet-sd15")
    small_reference_check("unet-svg", name="unet-sd15", policy="svg")
    # The smoke MMDiT (d 64, 4 heads of 16, 2 + 2 blocks, text 8 x 64), 12
    # Euler steps over 8 text + 16 image tokens.
    small_reference_check("flux-dev", name="flux-dev")
    # The vision family's smoke forwards: the ViT (4 x 4 grid behind the
    # cls token) off and at the fixed threshold, and EfficientNet.
    vision_reference_check("vit-l16", "vit-l16")
    vision_reference_check("vit-l16 ripple", "vit-l16", VIT_RIPPLE)
    vision_reference_check("efficientnet-b7", "efficientnet-b7")
    # The LM family's smoke configs: greedy generate in f32, card vs CPU.
    for name in LM_SMOKE:
        lm_reference_check(name)
    # The launcher's AdamW steps on the smoke dit-b2 in f32, card vs CPU.
    train_reference_check()
    # The offline-pattern policies: static on the default template, and
    # rainfusion under the artifact pattern_search[vdit] wrote.
    from repro_torch.core import patterns

    small_reference_check("static", policy="static")
    patterns.install_artifact(art_path)
    small_reference_check("rainfusion", policy="rainfusion")
    patterns.set_active_artifact(None)
    tp_launches = tp_phases_finish(tp_started)

    # 8k. the launch tools (slice 21): the dry run's counts of train[dit-xl2],
    # train[gemma3-4b] at the depth it ran and one serve[dit-xl2] forward,
    # made on the host beside the phases above, against their readings; last,
    # so the host processes have the whole run to finish ----------------------
    dryrun_phases(dryrun, train_out, lm_out, counts_d, prof_d, steps_d)

    kernels = [
        # Device times (torch.profiler, L2 flushed before each call) for
        # the three small kernels, with the host time of a wrapper call.
        {"name": "fused_reuse", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_reuse.cu",
         "replaces": "src/repro/kernels/reuse_mask/kernel.py:170",
         "launches": counts_r["fused_reuse"], "max_abs_err": serve_err1,
         **t1, "library_ms": None,
         # The same call writing its source map, as a decision-cache
         # refresh step launches it, and its launches in serve[ripple-cache].
         "src_ms": t1s["ms"], "src_host_ms": t1s["host_ms"],
         "src_plain_ms": t1s["plain_ms"], "src_bound_ms": t1s["bound_ms"],
         "launches_ripple_cache": counts_c["fused_reuse"],
         # unet-sd15: its launches in serve[unet-sd15] and the call at its
         # finest level, (4, 8, 16384, 40), T = 1, axes xy.
         "launches_unet": counts_u["fused_reuse"],
         "launches_rainfusion": counts_rf["fused_reuse"],
         # The engine and launcher phases (serve[policies], serve[launcher]).
         "launches_policies": counts_pol["fused_reuse"],
         "launches_launcher": counts_la["fused_reuse"],
         "launches_guardrail": counts_gr.get("fused_reuse", 0),
         # The crash drill's restart (serve[crash]): the steps left only.
         "launches_crash_restart": counts_cr.get("fused_reuse", 0), "unet_ms": t1u["ms"],
         "unet_plain_ms": t1u["plain_ms"], "unet_bound_ms": t1u["bound_ms"],
         # flux-dev: its launches in serve[flux-dev] and serve[flux-launcher],
         # and its served call (4, 24, 4608, 128), 512 text tokens, T = 1.
         "launches_flux": counts_f["fused_reuse"],
         "launches_flux_launcher": counts_fl["fused_reuse"], "flux": t1f,
         # serve[mesh]: the launcher under --mesh 2x2, 4 shards on one card.
         "launches_mesh": counts_mesh["fused_reuse"],
         # vit-l16: its launches in one serve_b128 forward of classify[vit-l16
         # ripple] and its call there, (128, 16, 197, 64), the cls token first.
         "launches_vit": counts_v["fused_reuse"], "vit": t1v},
        {"name": "ripple_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/ripple_attention.cu",
         "replaces": "src/repro/kernels/ripple/kernel.py:125",
         "launches": counts_r["ripple_attention"], "max_abs_err": serve_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib,
         # unet-sd15's head dims 40, 80 and 160 on their served calls, with
         # their launches in serve[unet-sd15].
         "launches_unet": counts_u["ripple_attention"],
         "launches_policies": counts_pol["ripple_attention"],
         "launches_launcher": counts_la["ripple_attention"],
         "launches_guardrail": counts_gr.get("ripple_attention", 0),
         "launches_crash_restart": counts_cr.get("ripple_attention", 0),
         "unet": unet_times,
         "launches_flux": counts_f["ripple_attention"],
         "launches_flux_launcher": counts_fl["ripple_attention"], "flux": flux_ripple,
         "launches_mesh": counts_mesh["ripple_attention"],
         # 197 tokens are odd: auto leaves the ViT's snapped operands to the
         # reference backend.
         "launches_vit": counts_v["ripple_attention"]},
        {"name": "sparse_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/sparse_attention.cu",
         "replaces": "src/repro/kernels/sparse/kernel.py:120",
         "launches": counts_s["sparse_attention"], "max_abs_err": serve_err3,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib,
         # Its launches on this slice's paths, and unet-sd15's four
         # served calls (all-FULL as svg serves them, and a constructed
         # spatial_local map with its bias) against SDPA by device time.
         "launches_static": counts_st["sparse_attention"],
         "launches_rainfusion": counts_rf["sparse_attention"],
         "launches_policies": counts_pol["sparse_attention"],
         "launches_unet_svg": counts_us["sparse_attention"],
         "launches_guardrail": counts_gr.get("sparse_attention", 0),
         "unet": unet_sparse_times,
         # The ring: sparse launches of ring[svg] at 2 and 4 shards (hops
         # not elided), the carry's chain of 4 against one call by device
         # time (sparse[carry], (1, 24, 8192, 128), both paths) and the
         # kernel-bench ring row.
         "launches_ring": ring_launches, "carry": carry_times,
         "ring_bench": ring_bench},
        # No single PyTorch call computes LayerNorm-and-modulate: the time
        # of F.layer_norm with its two elementwise ops is in the log line.
        {"name": "adaln", "route": "cuda",
         "source": "src/repro_torch/csrc/adaln.cu",
         "replaces": "src/repro/kernels/adaln/kernel.py:38",
         "launches": counts_d["adaln"], "max_abs_err": adaln_err,
         "ms": a_ms, "host_ms": a_host, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": None,
         # Training (slice 18): its launches in train[dit-xl2] (forward only;
         # the backward is PyTorch ops) and its gradient's largest relative
         # L2 error against autograd of the plain version (adaln[grad]).
         "launches_train": train_out["dit-xl2"]["launches"]["adaln"],
         # Slice 20: its launches in dist[train dit-xl2], the launcher under
         # torchrun at one rank with the state sharded by the rule tables.
         "launches_dist_train": train_out["dist dit-xl2"]["dit-xl2"]["launches"]["adaln"],
         # Slice 24: a rank's launches in dist[train dit-xl2 tp], 2 ranks on a
         # model axis of 2, 3 steps (the one process's are checked equal).
         "launches_dist_tp": tp_launches["dit-xl2"]["adaln"],
         "host_served_ms": a_host_ab[0], "host_function_ms": a_host_ab[1],
         "grad_max_rel_err": adaln_grad_err},
        # f32 at (1, 24, 8192, 128), as its path (the kernel_bench sweep)
        # launches it; the bf16 times at the serving shapes are log lines.
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash/kernel.py:61",
         "launches": counts_kb["flash_attention"], "max_abs_err": fl_err,
         "ms": fl_ms, "plain_ms": fl_plain, "bound_ms": fl_bound,
         "bound_by": fl_by, "library_ms": fl_lib,
         # Head dims up to 256 (slice 17), bf16 at gemma3-4b's global-layer
         # head shape, unmasked (on no path: the LM masks its logits).
         "head_dims": "d and dv up to 256, apart",
         "d256": {"shape": list(FLASH_D256_SHAPE), "dtype": "bfloat16",
                  "max_abs_err": fl256_err, "ms": fl256[0], "plain_ms": fl256[1],
                  "library_ms": fl256[2], "bound_ms": fl256[3], "bound_by": fl256[4]}},
        # No single PyTorch call computes the pair snap: the time of an
        # eager composite is in the log line.
        {"name": "reuse_snap", "route": "cuda",
         "source": "src/repro_torch/csrc/reuse_snap.cu",
         "replaces": "src/repro/kernels/reuse_mask/kernel.py:52",
         "launches": counts_sn["reuse_snap"], "max_abs_err": snap_err,
         "ms": sn_ms, "host_ms": sn_host, "plain_ms": sn_plain, "bound_ms": sn_bound,
         "bound_by": sn_by, "library_ms": None},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

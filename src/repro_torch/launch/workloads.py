"""Workloads of the port.  Serving: per-request latent shapes, attention
call shapes and a cell's attention plan, mixed generate shapes, a
deterministic request stream, per-request class labels, one denoiser
forward (vdit, dit, mmdit and unet families), the vdit's per-layer
decision-cache state, the vision family's classify step (vit and
effnet), and the LM family's prefill and decode steps, each under
``no_grad``.  Training: the diffusion, vision and LM losses of the JAX
workloads' ``_diffusion_train``, ``_vision_train`` and ``_lm_train``,
and :func:`train_step`, one AdamW step of a train cell.  The dry run:
:func:`build_workload`, one rank's step of any cell with its model and
inputs made."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import ArchConfig, ShapeSpec


def latent_shape_for(arch: ArchConfig, shape: ShapeSpec) -> Tuple[int, ...]:
    """Per-request latent shape (no batch dim) for one generate cell — the
    serving engine's bucket identity."""
    m = arch.model
    if arch.family == "dit":
        lr = m.latent_res(shape.img_res)
        return (lr, lr, m.in_channels)
    if arch.family in ("mmdit", "unet"):
        lr = shape.img_res // 8
        return (lr, lr, m.in_channels)
    if arch.family == "vdit":
        g = m.grid(img_res=shape.img_res)
        return (g[0] * m.t_patch, g[1] * m.patch, g[2] * m.patch,
                m.in_channels)
    raise ValueError(f"no latent shape for family {arch.family!r} in the "
                     f"port yet")


def attention_shapes(arch: ArchConfig,
                     shape: ShapeSpec) -> List[Tuple[int, int]]:
    """(tokens, head dim) of each distinct self-attention call of one
    forward: the joint text + grid attention of the vdit and the mmdit
    (flux-dev at gen_1024: (4608, 128)), the patch grid of the dit; for
    the unet one per level that attends, finest first,
    the mid block's last (unet-sd15 at gen_1024: (16384, 40), (4096,
    80), (1024, 160), (256, 160))."""
    m = arch.model
    if arch.family == "dit":
        return [(m.num_tokens(shape.img_res), m.d_model // m.num_heads)]
    if arch.family == "vdit":
        g = m.grid(img_res=shape.img_res)
        return [(g[0] * g[1] * g[2] + m.txt_tokens,
                 m.d_model // m.num_heads)]
    if arch.family == "mmdit":
        return [((shape.img_res // 8 // m.patch) ** 2 + m.txt_tokens,
                 m.d_model // m.num_heads)]
    if arch.family == "unet":
        side = latent_shape_for(arch, shape)[0]
        levels = len(m.ch_mult)
        out = [((side >> lvl) ** 2, m.ch * m.ch_mult[lvl] // m.num_heads)
               for lvl in range(levels) if 2 ** lvl in m.attn_res]
        out.append(((side >> (levels - 1)) ** 2,
                    m.ch * m.ch_mult[-1] // m.num_heads))
        return list(dict.fromkeys(out))
    raise ValueError(f"family {arch.family!r} is not ported yet")


def _cfg_factor(arch: ArchConfig) -> int:
    """The reference workloads' classifier-free-guidance batch factor:
    flux-dev is guidance-distilled (one pass), the others x2."""
    return 1 if arch.family == "mmdit" else 2


def attention_plan(arch: ArchConfig, shape: ShapeSpec, mesh=None,
                   policy: Optional[str] = None, *, on_cuda: bool = True):
    """The resolved dispatch plan of the cell's joint self-attention call
    at the reference workloads' batch (the shape's batch times the
    guidance factor), under ``mesh`` (default: the active dispatch mesh)
    so that its batch/head sharding is what a sharded run executes
    (DESIGN.md §10).  Metadata only; None for the unet, whose attention
    runs at several resolutions (``launch.serve.attention_plans`` gives
    each)."""
    from repro_torch.core import dispatch as dispatch_lib

    if arch.family == "unet":
        return None
    n, hd = attention_shapes(arch, shape)[0]
    b = max(shape.batch, 1) * _cfg_factor(arch)
    qk = (b, arch.model.num_heads, n, hd)
    return dispatch_lib.resolve_plan(qk, qk, arch.ripple, on_cuda=on_cuda,
                                     policy=policy, mesh=mesh)


def request_label(seed: int, num_classes: int) -> int:
    """A DiT request's class label, drawn from a CPU ``torch.Generator``
    seeded with the request's seed: the same on every device and
    whatever requests share its batch."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return int(torch.randint(0, num_classes, (), generator=gen))


def mixed_gen_shapes(arch: ArchConfig, *, smoke: bool = False,
                     base: Optional[ShapeSpec] = None):
    """Heterogeneous 'generate' cells for mixed-traffic serving: the base
    resolution and step count (default: the arch's first generate
    shape; ``smoke`` drops it to 64² and 3 steps) plus a
    half-resolution and a half-schedule variant, each its own engine
    bucket; duplicates of (resolution, steps) are dropped."""
    if base is None:
        base = next(s for s in arch.shapes if s.kind == "generate")
    if smoke:
        base = dataclasses.replace(base, img_res=64, steps=3)
    res_lo = max(base.img_res // 2, 32)
    steps_lo = max(base.steps // 2, 2)
    variants = [
        base,
        dataclasses.replace(base, name=f"{base.name}_r{res_lo}",
                            img_res=res_lo),
        dataclasses.replace(base, name=f"{base.name}_s{steps_lo}",
                            steps=steps_lo),
    ]
    seen, out = set(), []
    for s in variants:
        if (s.img_res, s.steps) not in seen:
            seen.add((s.img_res, s.steps))
            out.append(s)
    return tuple(out)


def mixed_request_stream(arch: ArchConfig, shapes, num_requests: int,
                         seed: int = 0, policy: Optional[str] = None,
                         reuse_every: Optional[int] = None,
                         stream_every: Optional[int] = None):
    """Round-robin (ShapeSpec, GenRequest) traffic over ``shapes`` with
    deterministic per-request text embeddings (numpy, seeded per
    request) of the model's text shape: ``txt_tokens`` x ``txt_dim``,
    else the unet's ``ctx_tokens`` x ``ctx_dim`` (77 x 768 for
    unet-sd15), else the JAX package's (8, 64) stand-in, which a family
    without text (the dit) ignores; and seeds.  Every request asks for
    the reuse policy ``policy``, the decision-cache cadence
    ``reuse_every`` and the streaming cadence ``stream_every`` (None:
    the engine's default; each is part of the bucket key)."""
    from repro_torch.serving.engine import GenRequest

    m = arch.model
    txt_tokens = getattr(m, "txt_tokens", getattr(m, "ctx_tokens", 8))
    txt_dim = getattr(m, "txt_dim", getattr(m, "ctx_dim", 64))
    out = []
    for i in range(num_requests):
        sp = shapes[i % len(shapes)]
        txt = 0.05 * np.random.default_rng(seed + i).standard_normal(
            (txt_tokens, txt_dim)).astype(np.float32)
        out.append((sp, GenRequest(
            request_id=i, txt=txt, steps=sp.steps, seed=seed + i,
            latent_shape=latent_shape_for(arch, sp), policy=policy,
            reuse_every=reuse_every, stream_every=stream_every)))
    return out


def vdit_decision_state(arch: ArchConfig, img_res: int, batch: int,
                        policy: Optional[str] = None) -> Optional[List]:
    """Per-layer decision-cache state for one vdit sampler invocation
    (DESIGN.md §13): one entry per layer, each None until the layer's
    first refresh (step 0 always refreshes, and the plan is then built
    from the layer's operands, so ``img_res`` and ``batch`` fix nothing
    ahead).  None when the config cannot cache (inactive ripple, or a
    policy without the capability): callers take the per-step path."""
    from repro_torch.core import decision_cache

    pol = policy or arch.ripple.policy
    if not decision_cache.supports_cache(arch.ripple, pol):
        return None
    return [None] * arch.model.num_layers


def _denoise_call(arch: ArchConfig, model, x: torch.Tensor, t: torch.Tensor,
                  cond: dict, step: Optional[int], total: Optional[int],
                  use_ripple: bool = True,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  dstate: Optional[List] = None, ctx=None):
    """One denoiser forward: ``cond`` holds ``txt`` for the vdit,
    ``labels`` for the dit, whose sigma channels are dropped (the DDIM
    path uses the noise prediction only), ``txt`` and ``vec`` for the
    mmdit (its velocity for the Euler path) and ``ctx`` for the unet.
    ``dstate`` threads the per-layer decision cache (vdit only); the
    call then returns ``(out, new_dstate)``.  ``ctx`` (a ``ShardCtx``
    with a ``tp``: a train step on a model axis) goes to the transformer
    families."""
    rip = arch.ripple if use_ripple else dataclasses.replace(
        arch.ripple, enabled=False)
    kw = dict(ripple=rip, step=step, total_steps=total,
              compute_dtype=compute_dtype)
    if ctx is not None and ctx.tp is not None:  # not the unet (train_ctx)
        kw["ctx"] = ctx
    if dstate is not None and arch.family != "vdit":
        raise ValueError(f"decision-cache state is only threaded through "
                         f"the vdit family, not {arch.family!r}")
    if arch.family == "dit":
        out = model(x, t, cond["labels"], **kw)
        return out[..., :arch.model.in_channels]
    if arch.family == "mmdit":
        return model(x, t, cond["txt"], cond["vec"], **kw)
    if arch.family == "unet":
        return model(x, t, cond["ctx"], **kw)
    if arch.family == "vdit":
        return model(x, t, cond["txt"], decision_state=dstate, **kw)
    raise ValueError(f"family {arch.family!r} is not ported yet")


def classify_step(arch: ArchConfig, shape: ShapeSpec, model):
    """The classify workload of a vision arch (the JAX workloads'
    ``_vision_serve``): ``fn(images)`` for one ``classify`` cell, images
    (batch, res, res, channels) float32 on any device, moved to the
    model's, to bf16 logits (batch, num_classes).  The ViT runs with
    ripple off, as the reference's step does."""
    from repro_torch.models.efficientnet import effnet_apply
    from repro_torch.models.vit import vit_apply

    if arch.family not in ("vit", "effnet") or shape.kind != "classify":
        raise ValueError(f"no classify workload for family {arch.family!r} "
                         f"at a {shape.kind!r} shape")
    m = arch.model
    want = (shape.batch, shape.img_res, shape.img_res, m.in_channels)
    device = next(model.parameters()).device

    @torch.no_grad()
    def fn(images: torch.Tensor) -> torch.Tensor:
        if tuple(images.shape) != want:
            raise ValueError(f"{shape.name} takes images {want}, not "
                             f"{tuple(images.shape)}")
        x = images.to(device)
        if arch.family == "vit":
            return vit_apply(model, x, m)
        return effnet_apply(model, x, m)

    return fn


def lm_serve_steps(arch: ArchConfig, shape: ShapeSpec, model, mesh=None):
    """The LM serving workloads of one ``prefill`` or ``decode`` cell (the
    JAX workloads' ``_lm_prefill`` / ``_lm_decode``), on the model's
    device: ``(prefill_fn, decode_fn)`` for
    :class:`~repro_torch.serving.engine.LMEngine`, in bf16 as the
    reference's steps run.  The KV cache holds ``shape.seq_len``
    positions; the batch is the caller's (the shapes' global batches of
    32 and 128 sequences do not fit one card's cache at 32768
    positions).  ``prefill_fn(tokens (B, S))`` -> (logits (B, 1, V),
    cache); ``decode_fn(token (B, 1), cache, index)`` -> (logits (B, 1,
    V), cache), the cache written in place.  Tokens on any device are
    moved to the model's.  Under a dispatch ``mesh`` they run with the
    reference's contexts, ``ShardCtx(mesh, decode_act_rules(mesh))`` for
    the prefill and, for a decode step, the rules with
    ``replicate_heads=arch.decode_replicate_heads`` (and the long-context
    layout from 262144 positions): a MoE then shards its experts over
    the mesh's ``model`` axis."""
    from repro_torch.distributed.sharding import (NULL_CTX, ShardCtx,
                                                  decode_act_rules)
    from repro_torch.models import transformer_lm as lm_lib

    if arch.family != "lm" or shape.kind not in ("prefill", "decode"):
        raise ValueError(f"no LM serving workload for family "
                         f"{arch.family!r} at a {shape.kind!r} shape")
    cfg, max_len = arch.model, shape.seq_len
    device = next(model.parameters()).device
    pre_ctx = dec_ctx = NULL_CTX
    if mesh is not None:
        pre_ctx = ShardCtx(mesh, decode_act_rules(mesh))
        dec_ctx = ShardCtx(mesh, decode_act_rules(
            mesh, long_context=max_len >= 262144,
            replicate_heads=arch.decode_replicate_heads))

    @torch.no_grad()
    def prefill_fn(tokens: torch.Tensor):
        return lm_lib.lm_prefill(model, tokens.to(device), cfg, max_len,
                                 ctx=pre_ctx)

    @torch.no_grad()
    def decode_fn(token: torch.Tensor, cache, index: int):
        return lm_lib.lm_decode_step(model, token.to(device), cache, index,
                                     cfg, ctx=dec_ctx)

    return prefill_fn, decode_fn


# --- training workloads --------------------------------------------------------

DIFFUSION_FAMILIES = ("dit", "mmdit", "unet", "vdit")
VISION_FAMILIES = ("vit", "effnet")
# The families whose train step runs on a model axis above 1.
TP_FAMILIES = ("dit", "mmdit", "vdit", "vit", "lm")


def model_axis_unported(family: str) -> str:
    """Why ``family``'s train step does not run on a model axis above 1."""
    return (f"the {family} train step under a model axis above 1 is not "
            f"ported (ROADMAP §1 item 4b: channel-parallel convolutions, "
            f"GroupNorm and batch statistics over channel pieces)")


def diffusion_loss(arch: ArchConfig, model, batch: dict,
                   noise: torch.Tensor, t: torch.Tensor, *,
                   compute_dtype: torch.dtype = torch.bfloat16, ctx=None):
    """The loss of the JAX workloads' ``_diffusion_train`` for given
    ``noise`` (shaped like ``batch["latents"]``) and timesteps ``t``:
    DDPM (``t`` int in [0, num_train_steps), ``add_noise``, a noise
    target) or, for the mmdit, rectified flow (``t`` in [0, 1],
    ``interpolate``, a velocity target); one forward with ripple off
    (the dit's sigma channels dropped) and the float32 MSE, under ``ctx``
    (``_denoise_call``).  Returns (loss, {"mse": loss})."""
    from repro_torch.diffusion.schedule import (DDPMSchedule,
                                                RectifiedFlowSchedule)

    x0 = batch["latents"]
    if arch.family == "mmdit":
        rf = RectifiedFlowSchedule()
        xt = rf.interpolate(x0, noise, t)
        target = rf.velocity_target(x0, noise)
        pred = _denoise_call(arch, model, xt, t, batch, None, None,
                             use_ripple=False, compute_dtype=compute_dtype,
                             ctx=ctx)
    else:
        xt = DDPMSchedule().add_noise(x0, noise, t)
        target = noise
        pred = _denoise_call(arch, model, xt, t.float(), batch, None, None,
                             use_ripple=False, compute_dtype=compute_dtype,
                             ctx=ctx)
    loss = torch.mean(torch.square(pred.float() - target.float()))
    return loss, {"mse": loss}


def draw_diffusion_noise(arch: ArchConfig, x0: torch.Tensor,
                         generator: torch.Generator):
    """(noise, t) of one micro-batch from a CPU ``generator``, moved to
    x0's device: standard normal noise, then t as the family's schedule
    samples it (uniform integers below ``num_train_steps``; the mmdit's
    rectified-flow ``sample_t``)."""
    from repro_torch.diffusion.schedule import (DDPMSchedule,
                                                RectifiedFlowSchedule)

    B = x0.shape[0]
    noise = torch.randn(x0.shape, generator=generator, dtype=x0.dtype)
    if arch.family == "mmdit":
        t = RectifiedFlowSchedule().sample_t(generator, B)
    else:
        t = torch.randint(0, DDPMSchedule().num_train_steps, (B,),
                          generator=generator)
    return noise.to(x0.device), t.to(x0.device)


def vision_loss(arch: ArchConfig, model, batch: dict, *,
                compute_dtype: torch.dtype = torch.bfloat16,
                remat: bool = False, ctx=None):
    """The loss of the JAX workloads' ``_vision_train``: the float32
    cross-entropy (logsumexp minus the gold logit) averaged over the
    batch, and the accuracy.  Returns (loss, {"acc": acc}).  Under
    ``ctx`` (a ``ShardCtx``) an EfficientNet's batch statistics cover
    the ranks of its ``batch_group``, and a ViT computes on the rank's
    model pieces where it has a ``tp``."""
    from repro_torch.models.efficientnet import effnet_apply
    from repro_torch.models.vit import vit_apply

    if arch.family == "vit":
        logits = vit_apply(model, batch["images"], arch.model,
                           compute_dtype=compute_dtype, remat=remat, ctx=ctx)
    else:
        logits = effnet_apply(model, batch["images"], arch.model,
                              compute_dtype=compute_dtype, remat=remat,
                              batch_group=getattr(ctx, "batch_group", None))
    logits = logits.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"acc": acc}


def train_loss_fn(arch: ArchConfig, ctx=None):
    """``loss_fn(model, batch, generator, rows=None) -> (loss, metrics)``
    of a train cell, at the config's ``train.compute_dtype`` (the
    reference's bfloat16 default): the diffusion loss on noise and t
    drawn from the generator, the vision loss with ``train.remat``, or
    the LM's next-token loss (``lm_loss``) with ``train.remat`` and
    ``train.remat_policy``.  ``rows`` (a slice) keeps those rows of the
    micro-batch, after the noise and t are drawn for all of it: a rank's
    piece of a micro-batch draws what the whole one draws there (the
    ranks of a model group keep the same rows: ``make_train_step`` picks
    them by the batch-group index).  ``ctx`` (a ``ShardCtx``) goes into
    the models: its ``tp`` (the model axis) to every family but the UNet
    and EfficientNet, its ``batch_group`` to an EfficientNet's batch
    statistics."""
    from repro_torch.distributed.sharding import NULL_CTX

    ctx = ctx or NULL_CTX
    tc = arch.train
    dt = getattr(torch, tc.compute_dtype)

    def keep(batch, rows):
        return batch if rows is None else {k: v[rows]
                                           for k, v in batch.items()}

    if arch.family in DIFFUSION_FAMILIES:
        def loss_fn(model, batch, generator, rows=None):
            noise, t = draw_diffusion_noise(arch, batch["latents"],
                                            generator)
            if rows is not None:
                noise, t = noise[rows], t[rows]
            return diffusion_loss(arch, model, keep(batch, rows), noise, t,
                                  compute_dtype=dt, ctx=ctx)
    elif arch.family in VISION_FAMILIES:
        def loss_fn(model, batch, generator, rows=None):
            return vision_loss(arch, model, keep(batch, rows),
                               compute_dtype=dt, remat=tc.remat, ctx=ctx)
    elif arch.family == "lm":
        from repro_torch.models.transformer_lm import lm_loss

        def loss_fn(model, batch, generator, rows=None):
            batch = keep(batch, rows)
            return lm_loss(model, batch["tokens"], batch["targets"],
                           arch.model, ctx=ctx, compute_dtype=dt,
                           remat=tc.remat, remat_policy=tc.remat_policy)
    else:
        raise ValueError(f"no train workload for family {arch.family!r}")
    return loss_fn


def _effective_accum(accum: int, global_batch: int, mesh) -> int:
    """Clamp grad accumulation so each micro-batch still divides the
    batch shards: the largest accum' <= accum with (B / accum') a
    multiple of the batch axes' size (on the 2x16x16 mesh the batch axis
    is 32-way, so micro-batches keep >= 32 samples)."""
    from repro_torch.distributed.sharding import axis_size, batch_axes

    if mesh is None:
        return accum
    shards = axis_size(mesh, batch_axes(mesh)) or 1
    a = min(accum, max(global_batch // shards, 1))
    while a > 1 and (global_batch % a or (global_batch // a) % shards):
        a -= 1
    return max(a, 1)


def train_step(arch: ArchConfig, shape: ShapeSpec, model, mesh=None):
    """The train workload of one ``train`` cell (the JAX workloads'
    ``_diffusion_train`` / ``_vision_train`` / ``_lm_train``) for
    ``model``: ``step(state, batch, seed) -> (state, metrics)``, one
    AdamW step over ``train.grad_accum`` micro-batches of the batch
    (``shape.batch``; an LM's ``shape.global_batch`` sequences of
    ``shape.seq_len`` tokens), on the model ``state.params`` (which must
    be ``model``'s config).  Under a rank ``mesh`` the accumulation is
    clamped so every micro-batch splits over the batch axes (the
    reference's ``_effective_accum``) and the state must be sharded over
    that mesh (``train_state_init(..., mesh=mesh)``); the vision cells
    keep ``grad_accum`` as the reference's do.  The loss's ``ShardCtx``
    carries the rank mesh's batch group (the MoE router's and an
    EfficientNet's batch statistics cover the whole batch) and no
    dispatch mesh.  On a mesh with a ``model`` axis above 1 it also
    carries the rank's tensor parallelism (``RankMesh.tensor_parallel``)
    and the rules (``train_act_rules``): the LM computes on the rank's
    model pieces (with ``train.seq_parallel``) and the MoE runs EP over
    the model group; the transformer diffusion and vision families
    (``TP_FAMILIES``) compute their blocks as regions, attention by
    heads or, where the heads do not divide the axis, by query rows
    (``attn_seq_fallback``, for the vision family too); the UNet and
    EfficientNet raise (ROADMAP §1 item 4b).  At a model axis of 1 the
    experts are not sharded and the MoE runs its dense path."""
    from repro_torch.training.train_loop import make_train_step

    if model.cfg != arch.model:
        raise ValueError("the model's config is not the arch's")
    if shape.kind != "train":
        raise ValueError(f"{shape.name} is a {shape.kind!r} shape, not a "
                         f"train shape")
    tc = arch.train
    if arch.family not in VISION_FAMILIES:  # the reference's vision cell
        batch = shape.global_batch if arch.family == "lm" else shape.batch
        tc = dataclasses.replace(tc, grad_accum=_effective_accum(
            tc.grad_accum, batch, mesh))
    return make_train_step(train_loss_fn(arch, train_ctx(arch, mesh)), tc)


def train_ctx(arch: ArchConfig, mesh=None):
    """The ``ShardCtx`` a train cell's loss runs under on a rank ``mesh``
    (None without one; see :func:`train_step`): the rules (but for the
    LM, ``attn_seq`` on ``model`` where the heads do not divide it, as
    the reference's ``_diffusion_train`` has it), the batch group, and
    the rank's tensor parallelism above a model axis of 1, with
    ``train.seq_parallel`` for the LM only (the reference's diffusion and
    vision steps take ``train_act_rules(mesh)`` without it)."""
    from repro_torch.distributed.sharding import (ShardCtx,
                                                  attn_seq_fallback,
                                                  train_act_rules)

    if mesh is None:
        return None
    if mesh.model_size > 1 and arch.family not in TP_FAMILIES:
        raise NotImplementedError(model_axis_unported(arch.family))
    lm = arch.family == "lm"
    sp = arch.train.seq_parallel and lm
    rules = train_act_rules(mesh, sp)
    return ShardCtx(rules=rules if lm else attn_seq_fallback(arch, mesh,
                                                             rules),
                    batch_group=mesh.batch_group(),
                    tp=mesh.tensor_parallel(sp))


# --- one cell's step, for the dry run ----------------------------------------

@dataclasses.dataclass
class Workload:
    """One (arch x shape) cell as the port runs it: ``fn(*args)`` is one
    rank's step (a train step, a prefill, a decode step, a classify
    batch, or one denoiser forward of a generate request's sampler, which
    runs ``steps_multiplier`` of them), on a model and inputs already
    made.  The counterpart of the JAX workloads' ``Workload``, whose
    ``fn`` is lowered instead of called."""

    arch: ArchConfig
    shape: ShapeSpec
    fn: object
    args: tuple
    steps_multiplier: int = 1


def build_workload(arch: ArchConfig, shape_name: str, mesh=None, *,
                   device=None, seed: int = 0) -> Workload:
    """The cell's step on ``device`` (default CUDA; a rank ``mesh``'s
    device), with a seeded model and seeded inputs.

    * train: :func:`train_step` on the launcher's first batch
      (``launch.train.make_batch_fn``) and its train state, sharded over
      ``mesh``'s ranks; params in ``train.param_dtype``;
    * generate: one ``_denoise_call`` with ripple on at the first step
      whose θ schedule snaps (``ripple.i_min``), on zero latents and
      conditioning, float32 params as the serving launcher's; the port's
      samplers run no classifier-free guidance, so the batch is the
      shape's, not doubled;
    * prefill / decode / classify: :func:`lm_serve_steps` (the decode
      step at the cache's last position) and :func:`classify_step`, bf16
      params as their serving runs.

    Serving holds whole weights on each rank, so under a mesh of N ranks
    a serving cell's step is the busiest rank's: ceil(batch / N) rows."""
    from repro_torch.models.params import init_model
    from repro_torch.utils.device import resolve_device

    shape = arch.shape(shape_name)
    dev = mesh.device if mesh is not None else resolve_device(device)
    ranks = 1 if mesh is None else mesh.size
    if shape.kind == "train":
        from repro_torch.data.synthetic import DataSpec
        from repro_torch.launch.train import make_batch_fn
        from repro_torch.training.train_loop import train_state_init

        model = init_model(arch.model, seed=seed,
                           device=dev if mesh is None else "cpu",
                           dtype=getattr(torch, arch.train.param_dtype))
        step = train_step(arch, shape, model, mesh=mesh)
        state = train_state_init(model, arch.train, mesh=mesh)
        batch = make_batch_fn(arch, shape, dev)(DataSpec(seed=seed), 0)
        return Workload(arch, shape, step, (state, batch, seed))
    field = "global_batch" if arch.family == "lm" else "batch"
    rows = -(-getattr(shape, field) // ranks)
    shape = dataclasses.replace(shape, **{field: rows})
    m = arch.model
    if shape.kind == "generate":
        model = init_model(m, seed=seed, device=dev)
        x = torch.zeros((rows, *latent_shape_for(arch, shape)), device=dev)
        t = torch.zeros((rows,), device=dev)
        if arch.family == "dit":
            cond = {"labels": torch.zeros((rows,), dtype=torch.long,
                                          device=dev)}
        elif arch.family == "unet":
            cond = {"ctx": torch.zeros((rows, m.ctx_tokens, m.ctx_dim),
                                       device=dev)}
        else:
            cond = {"txt": torch.zeros((rows, m.txt_tokens, m.txt_dim),
                                       device=dev)}
            if arch.family == "mmdit":
                cond["vec"] = torch.zeros((rows, 768), device=dev)
        steps = shape.steps or 50
        step = arch.ripple.i_min if arch.ripple.i_min < steps else 0

        @torch.no_grad()
        def denoise(x, t, cond):
            return _denoise_call(arch, model, x, t, cond, step, steps,
                                 use_ripple=True)

        return Workload(arch, shape, denoise, (x, t, cond),
                        steps_multiplier=steps)
    model = init_model(m, seed=seed, device=dev, dtype=torch.bfloat16)
    if shape.kind == "classify":
        images = torch.zeros((rows, shape.img_res, shape.img_res,
                              m.in_channels), device=dev)
        return Workload(arch, shape, classify_step(arch, shape, model),
                        (images,))
    prefill_fn, decode_fn = lm_serve_steps(arch, shape, model)
    if shape.kind == "prefill":
        tokens = torch.zeros((rows, shape.seq_len), dtype=torch.long,
                             device=dev)
        return Workload(arch, shape, prefill_fn, (tokens,))
    from repro_torch.models.transformer_lm import init_cache

    cache = init_cache(m, rows, shape.seq_len, torch.bfloat16, dev)
    token = torch.zeros((rows, 1), dtype=torch.long, device=dev)
    return Workload(arch, shape, decode_fn, (token, cache, shape.seq_len - 1))

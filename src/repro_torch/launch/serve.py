"""Serving launcher of the port: bucketed continuous-batching video and
image generation with TimeRipple on.

``python -m repro_torch.launch.serve`` runs on the CUDA card;
``--device cpu`` runs it on the CPU (kernel wrappers then take their
plain PyTorch versions).  ``--arch`` picks the model (``vdit-paper``,
the default, the image DiTs ``dit-xl2`` / ``dit-b2``, or the latent
UNet ``unet-sd15``, whose requests carry a 77 x 768 text context; the
image models are served at ``--shape gen_1024``).  ``--smoke`` serves
the smoke config at a 64² resolution for 3 steps; ``--override
key=value`` edits the config
(e.g. ``model.num_layers=8``, ``ripple.backend=dense``); ``--policy svg``
serves under the SVG block mask and ``--override ripple.svg_mask=true``
composes it with TimeRipple's snapping, both through the block-sparse
backend; ``--attn-backend`` picks the dispatch backend (``collapse``
runs the exact pair-collapse identities in plain PyTorch);
``--reuse-every R`` (or ``--override ripple.drift_tol=...``) serves the
vdit under the cross-step decision cache, and each served batch logs
``decision cache: N hits / M refreshes``.  ``--policy static`` serves
constant searched masks and ``--policy rainfusion`` routes each head to
its searched mask or to ripple's snapping (DESIGN.md §16), both through
the block-sparse backend; ``--pattern-artifact PATH`` installs the
artifact that ``launch/pattern_search.py`` wrote (without it they read
``REPRO_PATTERN_ARTIFACT`` or the user cache, and ``static`` falls back
to the grid's default template).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import torch

from repro_torch.config.base import apply_overrides
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core import decision_cache
from repro_torch.core import dispatch as dispatch_lib
from repro_torch.core import patterns
from repro_torch.diffusion.sampler import ddim_sample
from repro_torch.diffusion.schedule import DDPMSchedule
from repro_torch.launch.workloads import (_denoise_call, attention_shapes,
                                          latent_shape_for,
                                          mixed_request_stream,
                                          request_label,
                                          vdit_decision_state)
from repro_torch.models.params import init_dit, init_unet, init_vdit
from repro_torch.serving.engine import DiffusionEngine
from repro_torch.utils.device import resolve_device

log = logging.getLogger("repro_torch.launch.serve")


def build_sampler(arch, shape, model, *, use_ripple: bool = True,
                  policy=None, reuse_every=None,
                  compute_dtype: torch.dtype = torch.bfloat16):
    """Returns ``(sample_fn, latent_shape)``; ``sample_fn(noise, txt,
    seeds=None) -> latents`` runs the whole DDIM trajectory (no ported
    family is ``mmdit``, so the server samples with DDIM) on the model's
    device.  The dit family ignores ``txt`` and conditions each request
    on a class label drawn from its seed (``seeds``, one per row,
    required there); the unet attends to ``txt`` as its text context.
    ``policy`` overrides the arch config's reuse policy for this sampler,
    ``reuse_every`` its decision-cache cadence.

    With a cadence above 1 (or the drift guard on) on a cache-capable
    vdit config, the per-layer decision state is threaded through the
    sampler, the reuse decision is made anew only on refresh steps, and
    ``sample_fn`` returns ``(latents, aux)`` with the summed
    ``cache_hits`` / ``cache_refreshes`` counters.  As in the JAX
    launcher the cache is threaded for the vdit family only: a dit under
    those settings decides on every step."""
    if arch.family not in ("vdit", "dit", "unet"):
        raise ValueError(f"family {arch.family!r} is not ported yet")
    if policy:
        arch = dataclasses.replace(
            arch, ripple=dataclasses.replace(arch.ripple, policy=policy))
    if reuse_every is not None:
        arch = dataclasses.replace(
            arch, ripple=dataclasses.replace(arch.ripple,
                                             reuse_every=int(reuse_every)))
    rip = arch.ripple
    thread_cache = (use_ripple and arch.family == "vdit"
                    and (rip.reuse_every > 1 or rip.drift_tol > 0)
                    and decision_cache.supports_cache(rip))
    steps = shape.steps or 50
    ddpm = DDPMSchedule()

    def sample_fn(noise, txt, seeds=None):
        if arch.family == "dit":
            if seeds is None or len(seeds) != noise.shape[0]:
                raise ValueError("the dit sampler needs one seed per "
                                 "request for its class labels")
            labels = [request_label(s, arch.model.num_classes)
                      for s in seeds]
            cond = {"labels": torch.tensor(labels, device=noise.device)}
        elif arch.family == "unet":
            cond = {"ctx": txt}
        else:
            cond = {"txt": txt}

        if thread_cache:
            def denoise(x, t, step, dstate):
                out, dstate = _denoise_call(
                    arch, model, x, t, cond, step, steps,
                    use_ripple=use_ripple, compute_dtype=compute_dtype,
                    dstate=dstate)
                return out.to(x.dtype), dstate

            dstate = vdit_decision_state(arch, shape.img_res,
                                         noise.shape[0])
            lat, final = ddim_sample(denoise, noise, ddpm, steps,
                                     decision_state=dstate)
            return lat, {
                "cache_hits": sum(st.hits.sum() for st in final),
                "cache_refreshes": sum(st.refreshes.sum() for st in final)}

        def denoise(x, t, step):
            return _denoise_call(arch, model, x, t, cond, step, steps,
                                 use_ripple=use_ripple,
                                 compute_dtype=compute_dtype).to(x.dtype)

        return ddim_sample(denoise, noise, ddpm, steps)

    return sample_fn, latent_shape_for(arch, shape)


# A family's seeded initializer.
MODEL_INIT = {"vdit": init_vdit, "dit": init_dit, "unet": init_unet}


def model_summary(arch) -> str:
    """The served model's depth in the log: its layers, or for the unet
    its levels and base channels."""
    m = arch.model
    if arch.family == "unet":
        return (f"{len(m.ch_mult)} levels, ch {m.ch}, "
                f"n_res_blocks {m.n_res_blocks}")
    return f"{m.num_layers} layers"


def attention_plans(arch, shape, *, on_cuda: bool, policy=None):
    """``(tokens, head dim, plan)`` of each distinct self-attention call of
    a forward (:func:`attention_shapes`: one for the (v)DiT, one per
    attention level for the unet), each resolved at batch 1."""
    m = arch.model
    out = []
    for n, hd in attention_shapes(arch, shape):
        qk = (1, m.num_heads, n, hd)
        out.append((n, hd, dispatch_lib.resolve_plan(
            qk, qk, arch.ripple, on_cuda=on_cuda, policy=policy)))
    return out


def serving_shape(arch, name, *, smoke: bool, steps=None):
    """The named generate shape; ``smoke`` drops it to 64² and 3 steps;
    ``steps`` overrides the step count."""
    sp = arch.shape(name)
    if smoke:
        sp = dataclasses.replace(sp, img_res=64, steps=3)
    if steps is not None:
        sp = dataclasses.replace(sp, steps=int(steps))
    return sp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vdit-paper", choices=ALL_ARCHS)
    ap.add_argument("--shape", default=None,
                    help="the generate shape every request uses (default: "
                         "the arch's first, gen_512 for vdit-paper and "
                         "gen_1024 for the DiTs and the UNet)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke config, 64x64, 3 steps")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--steps", type=int, default=None,
                    help="denoising steps (default: the shape's)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--no-ripple", action="store_true")
    ap.add_argument("--policy", default=None,
                    help="reuse-policy name for every request (ripple, "
                         "svg, equal_mse, dense, static, rainfusion); "
                         "default: the arch config's ripple.policy")
    ap.add_argument("--pattern-artifact", default=None, metavar="PATH",
                    help="install a searched pattern artifact "
                         "(launch/pattern_search.py) for the static / "
                         "rainfusion policies; errors if the file is "
                         "missing or corrupt.  Default: the "
                         "REPRO_PATTERN_ARTIFACT env var / user cache "
                         "(loaded lazily, missing file tolerated)")
    ap.add_argument("--reuse-every", type=int, default=None, metavar="R",
                    help="decision-cache cadence: make the reuse decision "
                         "every R denoising steps and re-apply it in "
                         "between; part of the engine's bucket key.  "
                         "Default: the arch config's ripple.reuse_every "
                         "(1 = a decision every step)")
    ap.add_argument("--attn-backend", default=None,
                    choices=dispatch_lib.BACKENDS,
                    help="override RippleConfig.backend for the dispatch "
                         "layer (default: the arch config's setting)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override, e.g. model.num_layers=8")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")

    device = resolve_device(args.device)
    if args.pattern_artifact is not None:
        art = patterns.install_artifact(args.pattern_artifact)
        log.info("pattern artifact %s: %d heads, %.0f%% static",
                 art.version, len(art.heads),
                 100.0 * art.static_fraction())
    arch = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    arch = apply_overrides(arch, args.override)
    if args.attn_backend is not None:
        arch = dataclasses.replace(
            arch, ripple=dataclasses.replace(arch.ripple,
                                             backend=args.attn_backend))
    shape_name = args.shape or next(
        sp.name for sp in arch.shapes if sp.kind == "generate")
    shape = serving_shape(arch, shape_name, smoke=args.smoke,
                          steps=args.steps)
    model = MODEL_INIT[arch.family](arch.model, seed=args.seed, device=device)
    lat_shape = latent_shape_for(arch, shape)
    plans = attention_plans(arch, shape, on_cuda=device.type == "cuda",
                            policy=args.policy)
    log.info("device %s; %s (%s) at %s, %d steps, latents %s; plan %s",
             device, arch.name, model_summary(arch), shape.name,
             shape.steps, lat_shape, "; ".join(
                 (f"{n} tokens x d {hd}: " if len(plans) > 1 else "")
                 + plan.summary() for n, hd, plan in plans))

    def factory(shp, steps, policy=None, reuse_every=None):
        if (tuple(shp), steps) != (tuple(lat_shape), shape.steps):
            raise ValueError(f"no sampler for bucket {shp}, {steps} steps")
        return build_sampler(arch, shape, model,
                             use_ripple=not args.no_ripple,
                             policy=policy or args.policy,
                             reuse_every=reuse_every)[0]

    engine = DiffusionEngine(factory, device=device, max_batch=args.max_batch,
                             default_reuse_every=args.reuse_every)
    engine.start()
    t0 = time.time()
    done = []
    try:
        traffic = mixed_request_stream(arch, (shape,), args.requests,
                                       seed=args.seed)
        for _, req in traffic:
            engine.submit(req)
        for _, req in traffic:
            r = engine.result(req.request_id)
            done.append(r)
            log.info("request %d (%s, %d steps) done: latency %.3fs, "
                     "batch %d served in %.3fs; latents %s", req.request_id,
                     shape.name, shape.steps, r.latency_s, r.batch_index,
                     r.walltime_s, r.latents.shape)
    finally:
        engine.stop()
    log.info("served %d/%d requests in %.2fs", len(done), args.requests,
             time.time() - t0)
    return done


if __name__ == "__main__":
    main()

"""Serving launcher of the port: bucketed continuous-batching video and
image generation with TimeRipple on.

``python -m repro_torch.launch.serve`` runs on the CUDA card;
``--device cpu`` runs it on the CPU (kernel wrappers then take their
plain PyTorch versions).  ``--arch`` picks the model (``vdit-paper``,
the default, or the image DiTs ``dit-xl2`` / ``dit-b2``, served at
``--shape gen_1024``).  ``--smoke`` serves the smoke config at a 64²
resolution for 3 steps; ``--override key=value`` edits the config
(e.g. ``model.num_layers=8``, ``ripple.backend=dense``); ``--policy svg``
serves under the SVG block mask and ``--override ripple.svg_mask=true``
composes it with TimeRipple's snapping, both through the block-sparse
backend.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import torch

from repro_torch.config.base import apply_overrides
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core import dispatch as dispatch_lib
from repro_torch.core.policy import get_policy
from repro_torch.diffusion.sampler import ddim_sample
from repro_torch.diffusion.schedule import DDPMSchedule
from repro_torch.launch.workloads import (_denoise_call, attention_tokens,
                                          latent_shape_for,
                                          mixed_request_stream,
                                          request_label)
from repro_torch.models.params import init_dit, init_vdit
from repro_torch.serving.engine import DiffusionEngine
from repro_torch.utils.device import resolve_device

log = logging.getLogger("repro_torch.launch.serve")


def build_sampler(arch, shape, model, *, use_ripple: bool = True,
                  policy=None, compute_dtype: torch.dtype = torch.bfloat16):
    """Returns ``(sample_fn, latent_shape)``; ``sample_fn(noise, txt,
    seeds=None) -> latents`` runs the whole DDIM trajectory (neither
    vdit nor dit is ``mmdit``, so the server samples with DDIM) on the
    model's device.  The dit family ignores ``txt`` and conditions each
    request on a class label drawn from its seed (``seeds``, one per
    row, required there).  ``policy`` overrides the arch config's reuse
    policy for this sampler.

    A decision-cache setting (``reuse_every > 1`` or ``drift_tol > 0``)
    on a policy that can cache its decisions raises: the JAX launcher
    threads its cross-step decision cache there, which the port does not
    have yet, so serving on would give a different trajectory."""
    if arch.family not in ("vdit", "dit"):
        raise ValueError(f"family {arch.family!r} is not ported yet")
    if policy:
        arch = dataclasses.replace(
            arch, ripple=dataclasses.replace(arch.ripple, policy=policy))
    rip = arch.ripple
    pol = get_policy(rip.policy)
    if (use_ripple and rip.active() and pol.caches_decisions
            and (rip.reuse_every > 1 or rip.drift_tol > 0)):
        raise NotImplementedError(
            f"ripple.reuse_every={rip.reuse_every}, ripple.drift_tol="
            f"{rip.drift_tol} under policy {pol.name!r} ask for the "
            f"cross-step decision cache, which the port does not have yet "
            f"(ROADMAP item 7)")
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
        else:
            cond = {"txt": txt}

        def denoise(x, t, step):
            return _denoise_call(arch, model, x, t, cond, step, steps,
                                 use_ripple=use_ripple,
                                 compute_dtype=compute_dtype).to(x.dtype)

        return ddim_sample(denoise, noise, ddpm, steps)

    return sample_fn, latent_shape_for(arch, shape)


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
                         "gen_1024 for the DiTs)")
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
                         "svg, dense); default: the arch config's "
                         "ripple.policy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override, e.g. model.num_layers=8")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")

    device = resolve_device(args.device)
    arch = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    arch = apply_overrides(arch, args.override)
    shape_name = args.shape or next(
        sp.name for sp in arch.shapes if sp.kind == "generate")
    shape = serving_shape(arch, shape_name, smoke=args.smoke,
                          steps=args.steps)
    init = init_dit if arch.family == "dit" else init_vdit
    model = init(arch.model, seed=args.seed, device=device)
    sample_fn, lat_shape = build_sampler(arch, shape, model,
                                         use_ripple=not args.no_ripple,
                                         policy=args.policy)
    m = arch.model
    qk = (1, m.num_heads, attention_tokens(arch, shape),
          m.d_model // m.num_heads)
    plan = dispatch_lib.resolve_plan(qk, qk, arch.ripple,
                                     on_cuda=device.type == "cuda",
                                     policy=args.policy)
    log.info("device %s; %s (%d layers) at %s, %d steps, latents %s; "
             "plan %s", device, arch.name, m.num_layers, shape.name,
             shape.steps, lat_shape, plan.summary())

    def factory(shp, steps):
        if (tuple(shp), steps) != (tuple(lat_shape), shape.steps):
            raise ValueError(f"no sampler for bucket {shp}, {steps} steps")
        return sample_fn

    engine = DiffusionEngine(factory, device=device, max_batch=args.max_batch)
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

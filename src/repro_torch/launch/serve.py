"""Serving launcher of the port: bucketed continuous-batching video and
image generation with TimeRipple on.

``python -m repro_torch.launch.serve`` runs on the CUDA card;
``--device cpu`` runs it on the CPU (kernel wrappers then take their
plain PyTorch versions).  ``--arch`` picks the model (``vdit-paper``,
the default, the image DiTs ``dit-xl2`` / ``dit-b2``, the latent UNet
``unet-sd15``, whose requests carry a 77 x 768 text context, or the
MMDiT ``flux-dev``, sampled by Euler rectified flow on a 512 x 4096
text embedding and a zero pooled vector).
Without ``--shape`` the traffic is mixed, as in the reference launcher:
round-robin over the arch's first generate shape (``--steps`` sets its
step count), its half resolution and its half schedule, each its own
engine bucket, with one attention-plan line per bucket; ``--shape
NAME`` serves that shape only.  ``--smoke`` serves the smoke config at
a 64² base resolution for 3 steps; ``key=value`` overrides (positional,
or ``--override``) edit the config (e.g. ``model.num_layers=8``,
``ripple.backend=dense``); ``--policy svg`` serves under the SVG block
mask and ``ripple.svg_mask=true`` composes it with TimeRipple's
snapping, both through the block-sparse backend; ``--policy-module M``
imports M first so that it can register a policy of its own;
``--attn-backend`` picks the dispatch backend (``collapse`` runs the
exact pair-collapse identities in plain PyTorch); ``--reuse-every R``
and ``--drift-tol TOL`` serve the vdit under the cross-step decision
cache, and each served batch logs ``decision cache: N hits / M
refreshes``.  ``--policy static`` serves constant searched masks and
``--policy rainfusion`` routes each head to its searched mask or to
ripple's snapping (DESIGN.md §16), both through the block-sparse
backend; ``--pattern-artifact PATH`` installs the artifact that
``launch/pattern_search.py`` wrote (without it they read
``REPRO_PATTERN_ARTIFACT`` or the user cache, and ``static`` falls back
to the grid's default template); each bucket's sampler keeps the
artifact that was active when it was built.  ``--stream-every K``
delivers each request's latents every K steps through the engine's
``stream``; every request's log line carries its latency and its time
to the first frame (TTFF).  ``--summary-json PATH`` writes the
reference launcher's summary keys.

The serving control plane (DESIGN.md §15, §17): ``--replicas N`` serves
through a Router over N engines that share the loaded model and one
guardrail ladder; ``--scheduler edf|hottest`` picks the drain order;
``--deadline-ms MS`` stamps each request with a deadline at submit, and
a request that provably cannot meet it is shed (counted in the
summary's ``shed``).  Guardrails are on by default (``--no-guardrail``
turns them off): the samplers carry the non-finite and drift sentinels
and a tripped bucket steps down the degradation ladder.
``--batch-timeout S`` arms the hang watchdog; ``--inject-faults SPEC``
(or ``REPRO_FAULTS``) arms the fault-injection harness, whose
``kill_replica`` and ``crash`` the launcher fires.

Crash safety (DESIGN.md §18): ``--journal DIR`` writes the request
journal, chunk-boundary checkpoints (``--checkpoint-max`` of them at
most) and the service-time estimator under DIR, fsynced as
``--journal-fsync`` says; ``--resume`` first serves the requests the
journal left pending, each from its checkpoint where one lies on a
chunk boundary inside the run, and new request ids start above the
journaled ones.  SIGTERM drains gracefully (exit 143: the queue stays
journaled, the clean-shutdown marker is written); the ``crash`` fault
SIGKILLs the process once a checkpoint of work in flight is on disk.

The dispatch mesh (DESIGN.md §10, §14): ``--mesh DxM`` or ``--mesh
DxMxS`` builds a (data, model[, seq]) mesh over the visible cards (the
CPU with ``--device cpu``; ``REPRO_TORCH_FORCE_DEVICE_COUNT=N`` places N
shards on the first device, ``launch/mesh.py``) and installs it for the
run: attention shards over batch and heads wherever they divide (the
model runs once, on the first device), and a third component shards the
token axis for ring attention where a grid covers the whole sequence.
Each bucket logs its plan at every batch size it runs (``shard=
batchNxheadsM``, ``ring=seqS``), and the bucket key's fifth entry is the
seq degree.  A mesh larger than the visible devices raises.

Several processes (DESIGN.md §15.4): ``--distributed`` joins the
``torch.distributed`` process group before anything touches a device
(``launch.mesh.init_distributed``: ``env://`` under torchrun, else
``--coordinator HOST:PORT`` with ``--num-processes`` and
``--process-id``; NCCL on cards, each process on ``cuda:LOCAL_RANK``,
gloo with ``--device cpu``), then serves as one process does: each
process runs its own router in front of its own replicas.  A coordinator
that cannot be reached raises; the launcher never carries on as a
single process.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import signal
import sys
import threading
import time
import types

import torch

from repro_torch.config.base import apply_overrides
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core import decision_cache
from repro_torch.core import dispatch as dispatch_lib
from repro_torch.core import patterns
from repro_torch.core.guardrail import DegradationLadder
from repro_torch.core.policy import get_policy, list_policies
from repro_torch.diffusion.sampler import ddim_sample, euler_flow_sample
from repro_torch.diffusion.schedule import DDPMSchedule
from repro_torch.launch.mesh import (init_distributed, parse_mesh_spec,
                                     process_device)
from repro_torch.launch.workloads import (_denoise_call, attention_shapes,
                                          latent_shape_for,
                                          mixed_gen_shapes,
                                          mixed_request_stream,
                                          request_label,
                                          vdit_decision_state)
from repro_torch.models.params import (init_dit, init_mmdit, init_unet,
                                       init_vdit)
from repro_torch.serving import faults as fault_lib
from repro_torch.serving import journal as journal_lib
from repro_torch.serving.engine import DiffusionEngine, request_noise
from repro_torch.serving.router import Router
from repro_torch.serving.slo import ServiceEstimator, ShedError
from repro_torch.utils.device import resolve_device
from repro_torch.utils.diskio import atomic_write_text
from repro_torch.utils.logging import get_logger

log = get_logger("launch.serve")


def build_sampler(arch, shape, model, *, use_ripple: bool = True,
                  policy=None, reuse_every=None, stream_every=None,
                  sentinel: bool = False,
                  compute_dtype: torch.dtype = torch.bfloat16):
    """Returns ``(sample_fn, latent_shape)``; ``sample_fn(noise, txt,
    seeds=None) -> latents`` runs the whole trajectory on the model's
    device: Euler rectified flow for the mmdit family, DDIM for the
    others.  The dit family ignores ``txt`` and conditions each request
    on a class label drawn from its seed (``seeds``, one per row,
    required there); the unet attends to ``txt`` as its text context;
    the mmdit reads ``txt`` and a zero pooled ``vec``, as the reference
    launcher serves it.
    ``policy`` (a registered name or a policy instance, such as a
    pattern policy pinned to one artifact) overrides the arch config's
    reuse policy for this sampler, ``reuse_every`` its decision-cache
    cadence.

    With a cadence above 1 (or the drift guard on) on a cache-capable
    vdit config, the per-layer decision state is threaded through the
    sampler, the reuse decision is made anew only on refresh steps, and
    ``sample_fn`` returns ``(latents, aux)`` with the summed
    ``cache_hits`` / ``cache_refreshes`` counters.  As in the JAX
    launcher the cache is threaded for the vdit family only: a dit under
    those settings decides on every step.

    ``stream_every=K`` makes ``sample_fn`` a generator instead: it runs
    the trajectory in K-step chunks (the sampler's ``step_offset`` /
    ``total_steps`` slices, the same arithmetic as one run) and yields
    ``(latents, aux)`` after each, ``aux`` holding the decision-cache
    counters so far and ``__ckpt__ = {"step", "dstate"}``: the step the
    next chunk starts from and the per-layer decision state it needs
    (None without the cache), a chunk-boundary checkpoint for the
    engine's store (DESIGN.md §18).  The decision state crosses chunks
    unchanged, so the last chunk is the whole run's result bit for bit.
    ``sample_fn(x, txt, seeds, resume={"step": S, "dstate": state})``
    starts the chunk loop at step S from the latents ``x`` of that step
    and the checkpointed state; since checkpoints lie on chunk
    boundaries, the resumed run repeats the uninterrupted run's chunks
    and lands on its latents bit for bit.  A cache-threading sampler
    resumed without a state replays from step 0 instead, from the
    requests' initial noise (their ``seeds``).

    ``sentinel=True`` arms the guardrail sentinels (DESIGN.md §17): the
    sampler counts the non-finite latent entries of every step
    (``aux["latent_nonfinite"]``, the running total in each chunk) and,
    where the decision cache is threaded, dispatch folds each attention
    output's non-finite count and the dense probe
    (``ripple.sentinel_probe_every``) into the cache
    (``aux["sentinel_nonfinite"]`` / ``aux["sentinel_drift"]``); the
    sampler then always returns ``(latents, aux)``.  The readings stay
    device tensors, which the engine reads once a batch; they change no
    number of the trajectory."""
    if arch.family not in ("vdit", "dit", "mmdit", "unet"):
        raise ValueError(f"family {arch.family!r} is not ported yet")
    if sentinel:
        arch = dataclasses.replace(
            arch, ripple=dataclasses.replace(arch.ripple, sentinel=True))
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

    def make_cond(noise, txt, seeds):
        if arch.family == "dit":
            if seeds is None or len(seeds) != noise.shape[0]:
                raise ValueError("the dit sampler needs one seed per "
                                 "request for its class labels")
            labels = [request_label(s, arch.model.num_classes)
                      for s in seeds]
            return {"labels": torch.tensor(labels, device=noise.device)}
        if arch.family == "unet":
            return {"ctx": txt}
        if arch.family == "mmdit":
            return {"txt": txt, "vec": torch.zeros((txt.shape[0], 768),
                                                   device=noise.device)}
        return {"txt": txt}

    def run(x, cond, step0, count, dstate):
        """Steps [step0, step0 + count) of the trajectory (Euler for the
        mmdit, DDIM otherwise); returns (x, decision state or None,
        non-finite count or None)."""
        if dstate is None:
            def denoise(x, t, step):
                return _denoise_call(arch, model, x, t, cond, step, steps,
                                     use_ripple=use_ripple,
                                     compute_dtype=compute_dtype).to(x.dtype)

            kw = dict(step_offset=step0, total_steps=steps,
                      sentinel=sentinel)
            out = (euler_flow_sample(denoise, x, count, **kw)
                   if arch.family == "mmdit"
                   else ddim_sample(denoise, x, ddpm, count, **kw))
            return (out[0], None, out[1]) if sentinel else (out, None, None)

        def denoise(x, t, step, dstate):
            out, dstate = _denoise_call(
                arch, model, x, t, cond, step, steps, use_ripple=use_ripple,
                compute_dtype=compute_dtype, dstate=dstate)
            return out.to(x.dtype), dstate

        out = ddim_sample(denoise, x, ddpm, count, step_offset=step0,
                          total_steps=steps, decision_state=dstate,
                          sentinel=sentinel)
        return out if sentinel else out + (None,)

    def start_state(noise):
        return (vdit_decision_state(arch, shape.img_res, noise.shape[0])
                if thread_cache else None)

    def readings(dstate, nf) -> dict:
        """The cache counters and the sentinels, as device tensors."""
        aux = {}
        if dstate is not None:
            aux["cache_hits"] = sum(st.hits.sum() for st in dstate)
            aux["cache_refreshes"] = sum(st.refreshes.sum() for st in dstate)
            if dstate[0].nonfinite is not None:
                aux["sentinel_nonfinite"] = sum(st.nonfinite.sum()
                                                for st in dstate)
                aux["sentinel_drift"] = torch.stack(
                    [st.probe_err.max() for st in dstate]).max()
        if nf is not None:
            aux["latent_nonfinite"] = nf
        return aux

    if stream_every:
        chunk = int(stream_every)

        def stream_fn(noise, txt, seeds=None, resume=None):
            cond = make_cond(noise, txt, seeds)
            x, start, dstate, total = noise, 0, None, None
            if resume is not None:
                start = int(resume.get("step", 0))
                if thread_cache and resume.get("dstate") is not None:
                    # A copy: the model updates the list in place.
                    dstate = list(resume["dstate"])
                elif thread_cache and start > 0:
                    # A hit step without the cached plan would apply
                    # none: replay from step 0, from the initial noise.
                    if seeds is None:
                        raise ValueError("replaying a resumed request from "
                                         "step 0 needs its seed")
                    start = 0
                    x = torch.stack([request_noise(s, noise.shape[1:],
                                                   noise.device)
                                     for s in seeds])
            if dstate is None:
                dstate = start_state(noise)
            for step0 in range(start, steps, chunk):
                count = min(chunk, steps - step0)
                x, dstate, nf = run(x, cond, step0, count, dstate)
                if nf is not None:
                    # A running total: the last chunk reports the run.
                    total = nf if total is None else total + nf
                aux = readings(dstate, total)
                aux["__ckpt__"] = {"step": step0 + count, "dstate": (
                    None if dstate is None else list(dstate))}
                yield x, aux

        return stream_fn, latent_shape_for(arch, shape)

    def sample_fn(noise, txt, seeds=None):
        lat, dstate, nf = run(noise, make_cond(noise, txt, seeds), 0, steps,
                              start_state(noise))
        if dstate is None and nf is None:
            return lat
        return lat, readings(dstate, nf)

    return sample_fn, latent_shape_for(arch, shape)


def pinned_policy(arch, policy=None):
    """The policy a served sampler runs: ``policy`` (default: the arch
    config's), and for a pattern policy a copy pinned to the artifact
    active now, so that an artifact installed while its batches run
    does not reach them (the reference's jitted sampler folds the
    artifact in when it is traced).  A policy instance, such as the one
    the engine pinned when the request was submitted, is kept as it is."""
    if policy is not None and not isinstance(policy, str):
        return policy
    name = policy or arch.ripple.policy
    pin = getattr(get_policy(name), "pin", None)
    return pin() if pin is not None else policy


def make_sampler_factory(arch, shapes, model, *, use_ripple: bool = True,
                         device=None, sentinel: bool = False,
                         compute_dtype: torch.dtype = torch.bfloat16):
    """``(sampler_factory, plan_fn)`` for a :class:`DiffusionEngine` over
    the generate cells ``shapes``, keyed by the bucket's (latent_shape,
    steps).  The factory takes the bucket's policy (None: the arch
    config's), decision-cache cadence and streaming cadence, and builds
    the sampler around :func:`pinned_policy`: a ``static`` or
    ``rainfusion`` bucket runs the policy the engine pinned at submit,
    to the artifact whose version is the bucket's pattern token (a name
    is pinned when the sampler is built); ``sentinel`` arms every
    sampler's guardrail sentinels (:func:`build_sampler`).
    ``plan_fn`` gives the bucket's attention plans as one line for the
    log (``device``: where ``model`` runs, default CUDA)."""
    by_bucket = {(tuple(latent_shape_for(arch, sp)), sp.steps): sp
                 for sp in shapes}
    on_cuda = resolve_device(device).type == "cuda"

    def cell(latent_shape, steps):
        sp = by_bucket.get((tuple(latent_shape), steps))
        if sp is None:
            raise ValueError(f"no sampler for bucket {tuple(latent_shape)}, "
                             f"{steps} steps")
        return sp

    def factory(latent_shape, steps, policy=None, reuse_every=None,
                stream_every=None):
        return build_sampler(arch, cell(latent_shape, steps), model,
                             use_ripple=use_ripple,
                             policy=pinned_policy(arch, policy),
                             reuse_every=reuse_every,
                             stream_every=stream_every,
                             sentinel=sentinel,
                             compute_dtype=compute_dtype)[0]

    def plan_fn(latent_shape, steps, policy=None):
        return plans_summary(attention_plans(
            arch, cell(latent_shape, steps), on_cuda=on_cuda,
            policy=policy))

    return factory, plan_fn


# A family's seeded initializer.
MODEL_INIT = {"vdit": init_vdit, "dit": init_dit, "mmdit": init_mmdit,
              "unet": init_unet}


def model_summary(arch) -> str:
    """The served model's depth in the log: its layers, for the mmdit its
    double and single blocks, for the unet its levels and base
    channels."""
    m = arch.model
    if arch.family == "unet":
        return (f"{len(m.ch_mult)} levels, ch {m.ch}, "
                f"n_res_blocks {m.n_res_blocks}")
    if arch.family == "mmdit":
        return (f"{m.n_double_blocks} double + {m.n_single_blocks} single "
                f"blocks")
    return f"{m.num_layers} layers"


def attention_plans(arch, shape, *, on_cuda: bool, policy=None,
                    batch: int = 1):
    """``(tokens, head dim, plan)`` of each distinct self-attention call of
    a forward (:func:`attention_shapes`: one for the (v)DiT, one per
    attention level for the unet), each resolved at ``batch`` requests
    under the active dispatch mesh."""
    m = arch.model
    out = []
    for n, hd in attention_shapes(arch, shape):
        qk = (batch, m.num_heads, n, hd)
        out.append((n, hd, dispatch_lib.resolve_plan(
            qk, qk, arch.ripple, on_cuda=on_cuda, policy=policy)))
    return out


def plans_summary(plans) -> str:
    """One log line for :func:`attention_plans`: the plan, or with more
    than one attention shape each prefixed by its tokens and head dim."""
    return "; ".join((f"{n} tokens x d {hd}: " if len(plans) > 1 else "")
                     + plan.summary() for n, hd, plan in plans)


def serving_shape(arch, name, *, smoke: bool, steps=None):
    """The named generate shape; ``smoke`` drops it to 64² and 3 steps;
    ``steps`` overrides the step count."""
    sp = arch.shape(name)
    if smoke:
        sp = dataclasses.replace(sp, img_res=64, steps=3)
    if steps is not None:
        sp = dataclasses.replace(sp, steps=int(steps))
    return sp


def _maybe_kill_replica(front, fault, completed: int):
    """Fire a ``kill_replica`` fault (DESIGN.md §17.3) once ``completed``
    results have been read: fail the deepest router replica, so that its
    unserved requests requeue onto the survivors."""
    if fault is None or not isinstance(front, Router):
        return
    spec = fault.spec("kill_replica")
    if spec is None or completed < int(spec.param("after", 1)):
        return
    if fault.take("kill_replica") is None:
        return
    depths = front.depths()
    if not depths:
        return
    idx = max(depths, key=depths.get)
    log.warning("fault injection: killing replica %d (depth %d)",
                idx, depths[idx])
    front.fail_replica(idx)


def _maybe_crash(fault, completed: int, *, store=None, read=()):
    """Fire a ``crash`` fault (DESIGN.md §18) once ``completed`` results
    have been read: SIGKILL this process, with no drain and no
    clean-shutdown marker.  With ``wait_ckpt=1`` (default) and a
    checkpoint store, first wait (up to ``wait_s``, default 60 s) until
    a chunk checkpoint is written after this call began, for a request
    whose result was not read (``read``), so that the kill lands
    mid-generation rather than racing the sampler.  (A finished batch's
    checkpoints are discarded just after its results are published, so
    an entry on disk alone does not prove work in flight; a checkpoint
    is never written on a batch's final chunk, so a new one does.)"""
    if fault is None:
        return
    spec = fault.spec("crash")
    if spec is None or completed < int(spec.param("after", 1)):
        return
    if int(spec.param("wait_ckpt", 1)) and store is not None:
        deadline = time.time() + float(spec.param("wait_s", 60.0))
        writes = store.metrics()["checkpoint_writes"]

        def in_flight():
            return (store.metrics()["checkpoint_writes"] > writes
                    and set(store.rids()) - set(read))

        while not in_flight() and time.time() < deadline:
            time.sleep(0.01)
        if not in_flight():
            log.warning("crash fault: no checkpoint landed within the "
                        "wait budget; killing anyway")
    if fault.take("crash") is None:
        return
    log.warning("fault injection: SIGKILL self (hard crash, no drain)")
    sys.stderr.flush()
    os.kill(os.getpid(), signal.SIGKILL)


def _recover(args, store):
    """The journal's pending requests, to be served first: each with its
    deadline dropped (it has passed across the restart; shedding a
    journaled request would break the promise that every one completes)
    and, where its checkpoint lies on a chunk boundary strictly inside
    its run, the ``resume`` payload."""
    rec = journal_lib.recover(args.journal)
    if rec.events:
        log.info("journal %s: %d event(s), %d pending, clean=%s, "
                 "torn_tail=%s", args.journal, rec.events, len(rec.pending),
                 rec.clean, rec.torn)
    out = []
    if not (args.resume and rec.pending):
        return rec, out
    if not rec.clean:
        log.warning("crash detected (no matching clean-shutdown marker): "
                    "recovering %d pending request(s)", len(rec.pending))
    for rid, reqd in sorted(rec.pending.items()):
        try:
            req = journal_lib.request_from_dict(reqd)
        except (KeyError, ValueError, TypeError):
            log.exception("journaled request %s is unreadable; skipping", rid)
            continue
        req.deadline_s = None
        req.recovered = True
        ck = store.get(rid) if req.stream_every else None
        if ck and 0 < ck["step"] < req.steps \
                and ck["step"] % req.stream_every == 0:
            req.resume = {"step": ck["step"], "x": ck["x"],
                          "dstate": ck.get("dstate")}
            log.info("request %d resumes from step %d/%d", rid, ck["step"],
                     req.steps)
        out.append(req)
    return rec, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    # The generating families; the vision classifiers have no launcher.
    ap.add_argument("--arch", default="vdit-paper",
                    choices=[a for a in ALL_ARCHS
                             if get_config(a).family in MODEL_INIT])
    ap.add_argument("--shape", default=None,
                    help="single-shape traffic from this named generate "
                         "shape; default: mixed-shape traffic over the "
                         "arch's first generate shape (gen_512 for "
                         "vdit-paper, gen_1024 for the DiTs and the UNet), "
                         "its half resolution and its half schedule")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke config, 64x64, 3 steps")
    ap.add_argument("--distributed", action="store_true",
                    help="join the torch.distributed process group before "
                         "touching devices (several processes, DESIGN.md "
                         "§15.4); reads --coordinator/--num-processes/"
                         "--process-id, else torchrun's environment")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--mesh", default=None, metavar="DxMxS",
                    help="(data, model[, seq]) dispatch mesh, e.g. 2, 2x2 "
                         "or 1x1x2: attention shards over batch and heads "
                         "(a third component: the token axis, ring "
                         "attention)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--steps", type=int, default=None,
                    help="denoising steps of the base shape, before the "
                         "mixed variants are made (default: the shape's)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-compiled", type=int, default=8,
                    help="bounded LRU of per-bucket samplers")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="serve through a Router over N in-process engine "
                         "replicas that share one loaded model and one "
                         "guardrail ladder: least-loaded routing, "
                         "failover requeue")
    ap.add_argument("--scheduler", default="edf",
                    choices=("edf", "hottest"),
                    help="bucket drain order: deadline-aware EDF "
                         "(default) or the deepest bucket first")
    ap.add_argument("--deadline-ms", type=float, default=None, metavar="MS",
                    help="stamp every request with a deadline of now+MS "
                         "at submit; a request that provably cannot meet "
                         "it is shed at the door")
    ap.add_argument("--stream-every", type=int, default=None, metavar="K",
                    help="chunked streaming: deliver the latents every K "
                         "denoising steps and report the time to the "
                         "first frame (TTFF)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--no-ripple", action="store_true")
    ap.add_argument("--policy", default=None,
                    help="reuse-policy name for every request (built-ins: "
                         "ripple, svg, equal_mse, dense, static, "
                         "rainfusion; out-of-tree policies register via "
                         "--policy-module); default: the arch config's "
                         "ripple.policy")
    ap.add_argument("--policy-module", default=None, metavar="MODULE",
                    help="import this python module before serving so it "
                         "can register_policy() an out-of-tree policy")
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
    ap.add_argument("--drift-tol", type=float, default=None, metavar="TOL",
                    help="decision-cache drift guard: refresh early when "
                         "the sampled-channel Δ statistic moves more than "
                         "TOL (relative) from the cached decision's.  0 "
                         "disables (default: the arch config's "
                         "ripple.drift_tol)")
    ap.add_argument("--attn-backend", default=None,
                    choices=dispatch_lib.BACKENDS,
                    help="override RippleConfig.backend for the dispatch "
                         "layer (default: the arch config's setting)")
    ap.add_argument("--no-guardrail", action="store_true",
                    help="turn off the runtime quality guardrails: the "
                         "non-finite and drift sentinels and the "
                         "per-bucket degradation ladder.  On by default")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="arm the fault-injection harness "
                         "(serving/faults.py), e.g. "
                         "'attn_nan:step=1;kill_replica:after=1' or "
                         "'crash:after=1' (needs --journal).  Default: "
                         "the REPRO_FAULTS env var")
    ap.add_argument("--batch-timeout", type=float, default=None,
                    metavar="S",
                    help="hang-watchdog floor per batch in seconds (scaled "
                         "by the service-time estimator once observed); a "
                         "hung batch takes its replica down and its "
                         "requests fail over.  Default: no watchdog")
    ap.add_argument("--probe-interval", type=float, default=0.5,
                    metavar="S",
                    help="router health-probe cadence for re-admitting "
                         "recovered replicas (only with --replicas > 1)")
    ap.add_argument("--journal", default=None, metavar="DIR",
                    help="crash-safe serving (DESIGN.md §18): write the "
                         "request journal, chunk-boundary checkpoints and "
                         "the service-time estimator under DIR.  SIGTERM "
                         "drains gracefully and leaves a clean-shutdown "
                         "marker; SIGKILL leaves a recoverable journal")
    ap.add_argument("--resume", action="store_true",
                    help="serve the journal's pending requests (submitted, "
                         "never finished or shed) first, each resumed "
                         "from its chunk checkpoint where it has one; "
                         "requires --journal")
    ap.add_argument("--journal-fsync", default="always",
                    choices=journal_lib.FSYNC_POLICIES,
                    help="journal durability: fsync every append "
                         "(default), every few appends, or never (flush "
                         "only: survives SIGKILL, not a power loss)")
    ap.add_argument("--checkpoint-max", type=int, default=64, metavar="N",
                    help="bound on the requests with a checkpoint on disk "
                         "(the least recently written is evicted first)")
    ap.add_argument("--summary-json", default=None, metavar="PATH",
                    help="write the run's summary (submitted, completed, "
                         "errors, shed, recovered, resumed_from_step, "
                         "sigterm, counters) to PATH as JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override, e.g. model.num_layers=8")
    ap.add_argument("overrides", nargs="*", metavar="KEY=VALUE",
                    help="config overrides, as --override")
    args = ap.parse_args(argv)

    if args.distributed:
        init_distributed(coordinator_address=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id, device=args.device)
        device = process_device(args.device)
        log.info("process %d of %d on %s", torch.distributed.get_rank(),
                 torch.distributed.get_world_size(), device)
    else:
        device = resolve_device(args.device)
    mesh = parse_mesh_spec(args.mesh, device=device) if args.mesh else None
    if mesh is None:
        return _serve(args, ap, device, None)
    # The mesh is the run's: installed for it, the previous one restored.
    prev = dispatch_lib.set_dispatch_mesh(mesh)
    log.info("dispatch mesh: %s on %s", mesh.shape,
             sorted({str(d) for d in mesh.devices}))
    try:
        return _serve(args, ap, device, mesh)
    finally:
        dispatch_lib.set_dispatch_mesh(prev)


def _plan_logging(factory, arch, shapes, on_cuda: bool):
    """``factory`` whose samplers log the bucket's attention plans at each
    batch size they first run: under a mesh the sharding depends on the
    batch (``shard=batch2xheads2`` where it divides, the replicated
    batch axis where not)."""
    by_bucket = {(tuple(latent_shape_for(arch, sp)), sp.steps): sp
                 for sp in shapes}

    def logged(latent_shape, steps, policy=None, reuse_every=None,
               stream_every=None):
        fn = factory(latent_shape, steps, policy, reuse_every, stream_every)
        sp = by_bucket[(tuple(latent_shape), steps)]
        seen = set()

        def run(x, txt, seeds=None, **kw):
            if x.shape[0] not in seen:
                seen.add(x.shape[0])
                log.info("bucket %s at batch %d: plan %s", sp.name,
                         x.shape[0], plans_summary(attention_plans(
                             arch, sp, on_cuda=on_cuda, policy=policy,
                             batch=x.shape[0])))
            return fn(x, txt, seeds, **kw)

        return run

    return logged


def _serve(args, ap, device, mesh):
    """The launcher's body after the device and the mesh are set."""
    if args.policy_module:
        importlib.import_module(args.policy_module)
    if args.pattern_artifact is not None:
        art = patterns.install_artifact(args.pattern_artifact)
        log.info("pattern artifact %s: %d heads, %.0f%% static",
                 art.version, len(art.heads),
                 100.0 * art.static_fraction())
    if args.policy is not None and args.policy not in list_policies():
        ap.error(f"unknown policy {args.policy!r}; registered: "
                 f"{list_policies()} (use --policy-module to register an "
                 f"out-of-tree policy first)")
    spec = args.inject_faults or os.environ.get(fault_lib.ENV_VAR, "").strip()
    fault = None
    if spec:
        try:
            fault = fault_lib.parse_faults(spec)
        except ValueError as e:
            ap.error(str(e))
    if args.resume and not args.journal:
        ap.error("--resume requires --journal DIR")
    if fault is not None and fault.spec("crash") is not None \
            and not args.journal:
        # A crash drill recovers from the journal; without one it would
        # only kill the process.
        ap.error("the 'crash' fault needs --journal DIR")
    arch = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    arch = apply_overrides(arch, args.override + args.overrides)
    ripple = {}
    if args.attn_backend is not None:
        ripple["backend"] = args.attn_backend
    if args.drift_tol is not None:
        ripple["drift_tol"] = args.drift_tol
    if ripple:
        arch = dataclasses.replace(
            arch, ripple=dataclasses.replace(arch.ripple, **ripple))
    if args.shape is not None:
        shapes = (serving_shape(arch, args.shape, smoke=args.smoke,
                                steps=args.steps),)
    else:
        base = next(sp.name for sp in arch.shapes if sp.kind == "generate")
        shapes = mixed_gen_shapes(arch, base=serving_shape(
            arch, base, smoke=args.smoke, steps=args.steps))
    # Every request names its policy (the config's without --policy), so
    # a pattern policy's token is in its bucket key.
    policy = args.policy or arch.ripple.policy
    model = MODEL_INIT[arch.family](arch.model, seed=args.seed, device=device)
    log.info("traffic buckets: %s",
             [(sp.name, sp.img_res, sp.steps) for sp in shapes])
    # One plan line a bucket, here rather than through the engine's
    # plan_fn: every bucket of a run has one policy.
    for sp in shapes:
        log.info("device %s; %s (%s) at %s, %d steps, latents %s; plan %s",
                 device, arch.name, model_summary(arch), sp.name, sp.steps,
                 latent_shape_for(arch, sp), plans_summary(attention_plans(
                     arch, sp, on_cuda=device.type == "cuda", policy=policy)))

    guardrail = not args.no_guardrail
    # One ladder for every replica: a degraded bucket stays degraded
    # across a failover.
    ladder = DegradationLadder() if guardrail else None
    factory, _ = make_sampler_factory(
        arch, shapes, model, use_ripple=not args.no_ripple, device=device,
        sentinel=guardrail)
    if mesh is not None:
        factory = _plan_logging(factory, arch, shapes,
                                device.type == "cuda")

    # Crash safety: scan before the journal opens (opening it removes the
    # clean-shutdown marker).
    journal = store = estimator = est_path = None
    recovered, rid_base = [], 0
    if args.journal:
        store = journal_lib.CheckpointStore(
            args.journal, max_entries=args.checkpoint_max,
            fsync=args.journal_fsync != "never")
        rec, recovered = _recover(args, store)
        journal = journal_lib.Journal(args.journal, fsync=args.journal_fsync)
        est_path = os.path.join(args.journal, "estimator.json")
        estimator = ServiceEstimator()
        if os.path.exists(est_path):
            try:
                with open(est_path, "r", encoding="utf-8") as f:
                    estimator = ServiceEstimator.from_json(f.read())
                log.info("restored service-time estimator from %s", est_path)
            except (OSError, ValueError):
                log.warning("could not restore estimator from %s; "
                            "starting cold", est_path)
        # New ids never alias journaled history.
        rid_base = max(set(rec.pending) | set(rec.finished) | set(rec.shed),
                       default=-1) + 1

    def make_engine():
        return DiffusionEngine(factory, device=device,
                               max_batch=args.max_batch,
                               max_compiled=args.max_compiled,
                               default_reuse_every=args.reuse_every,
                               scheduler=args.scheduler, guardrail=ladder,
                               batch_timeout_s=args.batch_timeout,
                               estimator=estimator, journal=journal,
                               checkpoint_store=store)

    if args.replicas > 1:
        front = Router([make_engine() for _ in range(args.replicas)],
                       probe_interval_s=args.probe_interval,
                       checkpoint_store=store)
    else:
        front = make_engine()
    traffic = mixed_request_stream(arch, shapes, args.requests,
                                   seed=args.seed, policy=policy,
                                   reuse_every=args.reuse_every,
                                   stream_every=args.stream_every)
    if fault is not None:
        fault_lib.install_faults(fault)
    terminating = {"sigterm": False}
    prev_handler = None
    if journal is not None and \
            threading.current_thread() is threading.main_thread():
        def _graceful(signum, frame):
            # The graceful drain: queued requests stay journaled as
            # pending, work in flight is checkpointed; the finally below
            # stops without drain and writes the clean-shutdown marker.
            terminating["sigterm"] = True
            log.warning("SIGTERM: graceful drain; pending work stays "
                        "journaled for --resume")
            raise SystemExit(143)

        prev_handler = signal.signal(signal.SIGTERM, _graceful)
    t0 = time.time()
    done, errors, submitted, shed = [], {}, [], 0
    try:
        # A single engine gets every request before its worker starts, so
        # its batches do not depend on how fast they are submitted; the
        # router routes only to running replicas.
        if args.replicas > 1:
            front.start()
        for req in recovered:
            sp = types.SimpleNamespace(name="recovered", steps=req.steps)
            try:
                front.submit(req)
            except (ShedError, ValueError) as e:
                shed += isinstance(e, ShedError)
                log.warning("recovered request %d: %s", req.request_id, e)
                continue
            submitted.append((sp, req))
        for sp, req in traffic:
            req.request_id += rid_base
            if args.deadline_ms is not None:
                req.deadline_s = time.time() + args.deadline_ms / 1e3
            try:
                front.submit(req)
            except ShedError as e:
                shed += 1
                log.warning("%s", e)
                continue
            submitted.append((sp, req))
        if args.replicas <= 1:
            front.start()
        for n_done, (sp, req) in enumerate(submitted):
            _maybe_kill_replica(front, fault, n_done)
            _maybe_crash(fault, n_done, store=store,
                         read={r.request_id for r in done} | set(errors))
            try:
                # A streaming request's chunks as a client reads them; the
                # stream ends when its result lands.
                chunks = (sum(1 for _ in front.stream(req.request_id))
                          if req.stream_every else 0)
                r = front.result(req.request_id)
            except (RuntimeError, TimeoutError) as e:
                errors[req.request_id] = str(e)
                log.error("request %d failed: %s", req.request_id, e)
                continue
            done.append(r)
            log.info("request %d (%s, %d steps) done: latency %.3fs, ttff "
                     "%.3fs%s, batch %d served in %.3fs%s%s%s; latents %s",
                     req.request_id, sp.name, sp.steps, r.latency_s,
                     r.ttff_s, f" ({chunks} chunks)" if chunks else "",
                     r.batch_index, r.walltime_s,
                     "" if r.deadline_met is None else
                     f", deadline {'met' if r.deadline_met else 'MISSED'}",
                     ", DEGRADED" if r.degraded else "",
                     ", RECOVERED" if req.recovered else "", r.latents.shape)
    except SystemExit:
        if not terminating["sigterm"]:
            raise
    finally:
        front.stop(drain=not terminating["sigterm"])
        if fault is not None:
            fault_lib.clear_faults()
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        if journal is not None:
            journal.close(clean=True)
            atomic_write_text(est_path, estimator.to_json())
    counters = dict(front.metrics())
    if fault is not None:
        counters.update(fault.counters())
    if ladder is not None:
        counters.update(ladder.metrics())
    resumed_from = max([int(v) for k, v in counters.items()
                        if k.endswith("last_resume_step")] or [0])
    log.info("served %d/%d requests (%d shed, %d recovered, deepest resume "
             "step %d) over %d bucket(s) in %.2fs; counters %s", len(done),
             args.requests + len(recovered), shed, len(recovered),
             resumed_from, len(shapes), time.time() - t0, counters)
    if args.summary_json:
        summary = {
            "submitted": [req.request_id for _, req in submitted],
            "completed": [r.request_id for r in done],
            "errors": {str(k): v for k, v in errors.items()},
            "shed": shed, "recovered": len(recovered),
            "resumed_from_step": resumed_from,
            "sigterm": terminating["sigterm"],
            "counters": {k: (float(v) if isinstance(v, float) else int(v))
                         for k, v in counters.items()},
        }
        with open(args.summary_json, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
        log.info("wrote summary to %s", args.summary_json)
    if terminating["sigterm"]:
        sys.exit(143)
    return done


if __name__ == "__main__":
    main()

"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch dit-xl2 --shape train_256 --steps 200 [--smoke] [--ckpt-dir DIR]
[--device cuda|cpu] [overrides...]``, the JAX package's
``launch/train.py`` on one card.

Wires: config -> seeded model (the reference's zero init, drawn on the
CPU) -> train state
(float32 params and AdamW moments) -> synthetic data pipeline -> the
cell's train step (``launch.workloads.train_step``: the diffusion,
vision or LM loss, ``train.grad_accum`` micro-batches, bfloat16
compute) -> host loop with async checkpointing and auto-resume (restart
the same command after a crash and it continues from the newest valid
checkpoint, drawing the batches and the noise the uninterrupted run
would have drawn).  Runs on the card unless ``--device cpu``.

Several processes: started by torchrun (``python -m
torch.distributed.run --nproc_per_node N -m repro_torch.launch.train
...``), each process joins the process group (``launch.mesh.
init_distributed``: NCCL on cards, gloo with ``--device cpu``), lays the
ranks out as a (data, model) rank mesh and trains with parameters,
gradients and AdamW state sharded over ``data`` by the rule tables
(``distributed.fsdp``): each rank draws the whole batch and keeps its
rows of every micro-batch.  Checkpoints hold whole arrays, written by
rank 0, and a restore at any number of ranks takes each rank's pieces.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config.base import ShapeSpec, apply_overrides
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.data import synthetic
from repro_torch.launch import workloads
from repro_torch.launch.mesh import (init_distributed, launched_by_torchrun,
                                     make_rank_mesh, process_device)
from repro_torch.models.params import init_model
from repro_torch.training import train_loop
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("launch.train")


def make_batch_fn(arch, shape: ShapeSpec, device=None):
    """``batch_fn(spec, index) -> batch`` of a train cell, on ``device``:
    the reference launcher's batches for the lm (``global_batch`` token
    sequences and their targets), dit (latents and class labels), mmdit
    (latents, text and a pooled vector), unet (latents and text
    context), vdit (latent videos and text) and vision (images and
    labels) families."""
    fam = arch.family
    m = arch.model
    if fam == "lm":
        return lambda spec, i: synthetic.token_batch(
            spec, i, shape.global_batch, shape.seq_len, m.vocab_size,
            device=device)
    if fam in workloads.DIFFUSION_FAMILIES:
        def diff_batch(spec, i):
            if fam == "dit":
                lr = m.latent_res(shape.img_res)
                b = synthetic.latent_video_batch(spec, i, shape.batch,
                                                 (1, lr, lr), m.in_channels)
                gen = synthetic.batch_generator(spec.seed, i, spec.shard)
                labels = torch.randint(0, m.num_classes, (shape.batch,),
                                       generator=gen)
                return {"latents": b["latents"][:, 0].to(device),
                        "labels": labels.to(device)}
            if fam in ("mmdit", "unet"):
                lr = shape.img_res // 8
                tok = m.txt_tokens if fam == "mmdit" else m.ctx_tokens
                dim = m.txt_dim if fam == "mmdit" else m.ctx_dim
                b = synthetic.latent_video_batch(
                    spec, i, shape.batch, (1, lr, lr), m.in_channels,
                    txt_tokens=tok, txt_dim=dim)
                out = {"latents": b["latents"][:, 0].to(device)}
                if fam == "unet":
                    out["ctx"] = b["txt"].to(device)
                    return out
                gen = synthetic.batch_generator(spec.seed + 3, i, spec.shard)
                out["txt"] = b["txt"].to(device)
                out["vec"] = (0.05 * torch.randn((shape.batch, 768),
                                                 generator=gen)).to(device)
                return out
            g = m.grid(img_res=shape.img_res)
            return synthetic.latent_video_batch(
                spec, i, shape.batch,
                (g[0] * m.t_patch, g[1] * m.patch, g[2] * m.patch),
                m.in_channels, txt_tokens=m.txt_tokens, txt_dim=m.txt_dim,
                device=device)
        return diff_batch
    return lambda spec, i: synthetic.image_batch(
        spec, i, shape.batch, shape.img_res, channels=m.in_channels,
        num_classes=m.num_classes, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-override", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("overrides", nargs="*",
                    help="config overrides like train.learning_rate=1e-4")
    args = ap.parse_args(argv)
    mesh = None
    if launched_by_torchrun():
        init_distributed(device=args.device)
        mesh = make_rank_mesh(device=args.device)
        device = mesh.device
        log.info("rank %d of %d on %s (%s): rank mesh %s", mesh.batch_index(),
                 mesh.size, device, torch.distributed.get_backend(),
                 mesh.shape)
    else:
        device = resolve_device(args.device)
    writer = mesh is None or torch.distributed.get_rank() == 0

    arch = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    arch = apply_overrides(arch, args.overrides)
    shape = arch.shape(args.shape)
    if args.batch_override:
        field = ("global_batch" if arch.family == "lm" else "batch")
        shape = dataclasses.replace(shape, **{field: args.batch_override})
        arch = dataclasses.replace(
            arch, shapes=tuple(shape if s.name == shape.name else s
                               for s in arch.shapes))
    batch_fn = make_batch_fn(arch, shape, device)

    # Drawn on the CPU, so a run's initial weights (like its batches and
    # noise) are the same on every device and every rank; on several
    # ranks only each rank's pieces go to its device (train_state_init).
    model = init_model(arch.model, seed=args.seed, device="cpu",
                       dtype=getattr(torch, arch.train.param_dtype))
    if mesh is None:
        model = model.to(device)
    step_fn = workloads.train_step(arch, shape, model, mesh=mesh)
    state = train_loop.train_state_init(model, arch.train, mesh=mesh)

    ckpt = None
    start_step = 0
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir, keep=3,
                            async_save=arch.checkpoint.async_save)
        found, arrays, _ = ckpt.restore_latest()
        if found is not None:
            state = train_loop.load_state_tree(state, arrays)
            start_step = found
            log.info("resumed from checkpoint step %d", start_step)

    spec = synthetic.DataSpec(seed=args.seed)
    it = synthetic.batch_iterator(batch_fn, spec, start_index=start_step)
    state, history = train_loop.run_train_loop(
        step_fn, state, it, args.steps, seed=args.seed,
        checkpointer=ckpt, checkpoint_every=args.ckpt_every if ckpt else 0,
        start_step=start_step, writer=writer)
    if ckpt:
        ckpt.wait()
    final = history[-1] if history else {}
    log.info("training done: %s", final)
    return state, history


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()

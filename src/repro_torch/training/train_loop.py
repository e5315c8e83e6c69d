"""Train-step construction and the host-side training loop, as the JAX
package's ``training/train_loop.py`` composes them.

``make_train_step`` composes: loss -> gradients (``backward()``, with
optional micro-batch accumulation) -> optional int8 error-feedback
compression (``distributed.collectives``) -> AdamW (in place) ->
optional EMA, into one function whose signature is the same for every
family::

    train_step(state, batch, seed) -> (state, metrics)

Randomness (the diffusion loss's noise and timesteps) comes from a CPU
``torch.Generator`` a micro-batch, seeded from (seed, step, micro):
the draws do not depend on the device, and a run resumed from a
checkpoint at step s draws what the uninterrupted run drew there.  The
reference restarts its key chain from the seed on resume instead, so
its resumed run draws other noise (a deliberate difference).

On several ranks (a train state made with a rank mesh) the parameters,
gradients, moments, residual and EMA are sharded over the batch axes
(``distributed.fsdp``: a block's parameters are whole only while it
runs and for its backward pass): each rank runs its rows of every micro-batch
(after drawing the micro-batch's noise whole), the gradients are
averaged over the ranks, and the clip norm and the compression scales
cover the whole tensors.  On a mesh with a ``model`` axis the pieces
are 2-D: the ranks of a model group run the same rows, each with its
model pieces (the loss's ``ShardCtx.tp``), and AdamW, the clip norm and
the compression run on the pieces as they are.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config.base import TrainConfig
from repro_torch.data.synthetic import batch_generator
from repro_torch.distributed.collectives import (CompressionState,
                                                 compress_grads,
                                                 compression_init)
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update)
from repro_torch.utils.logging import get_logger

log = get_logger("train")


class TrainState(NamedTuple):
    """``params`` is the model, trained in place; ``opt`` holds the AdamW
    moments aligned with ``list(params.parameters())``; ``compression``
    the int8 residuals when ``train.grad_compression`` is on; ``ema`` a
    float copy of each parameter, or None.  With ``shards`` (a
    ``distributed.fsdp.ParamShards``) the moments, residuals and EMA are
    this rank's pieces and the model's parameters live in
    ``shards.local`` between steps."""

    params: nn.Module
    opt: AdamWState
    compression: Optional[CompressionState]
    ema: Optional[List[torch.Tensor]]
    shards: Optional[Any] = None


def train_state_init(model: nn.Module, cfg: TrainConfig,
                     mesh=None) -> TrainState:
    """Zero moments (and residuals) and step 0; every parameter set to
    require grad.  With a rank ``mesh`` the state is sharded over its
    batch axes."""
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    shards = None
    if mesh is not None:
        from repro_torch.distributed.fsdp import ParamShards

        shards = ParamShards(model, mesh)
        params = shards.local
    ema = ([p.detach().clone() for p in params] if cfg.ema_decay
           else None)
    comp = compression_init(params) if cfg.grad_compression else None
    return TrainState(model, adamw_init(params), comp, ema, shards)


LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_train_step(loss_fn: LossFn, cfg: TrainConfig) -> Callable:
    """loss_fn(model, batch, generator) -> (scalar loss, metrics dict).

    With ``grad_accum`` A > 1 each batch entry's leading dim B splits as
    ``reshape(A, B // A)``, so micro-batch i is rows [i·B/A, (i+1)·B/A);
    the float32 gradients of the micro-batches are summed, then divided
    by A, and the loss and metrics averaged, as the reference's scan
    does.  Gradients are taken with grad mode on whatever the caller's
    mode.  On a sharded state the rank of batch index r of N (the batch
    axes' ranks) runs ``loss_fn(model, micro_batch, generator,
    rows=slice)`` on the r-th of N equal pieces of each micro-batch's
    rows, as GSPMD shards the reference's (A, B/A) reshape over ``data``;
    the loss must draw its randomness for the whole micro-batch before it
    keeps ``rows``."""
    accum = max(cfg.grad_accum, 1)

    def compute_grads(model, params, batch, seed, step, shards=None):
        for p in params:
            p.grad = None
        micros, rows = [batch], None
        if accum > 1 or shards is not None:
            sizes = {v.shape[0] for v in batch.values()}
            if len(sizes) != 1 or next(iter(sizes)) % accum:
                raise ValueError(f"batch sizes {sorted(sizes)} do not split "
                                 f"into grad_accum={accum} micro-batches")
            per = next(iter(sizes)) // accum
        if accum > 1:
            micros = [{k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                      for i in range(accum)]
        if shards is not None:
            if per % shards.n:
                raise ValueError(f"micro-batches of {per} rows do not split "
                                 f"over {shards.n} ranks")
            m = per // shards.n
            rows = slice(shards.index * m, (shards.index + 1) * m)
        losses, metrics = [], []
        with torch.enable_grad():
            for i, mb in enumerate(micros):
                gen = batch_generator(seed, step, i)
                loss, m = (loss_fn(model, mb, gen) if rows is None else
                           loss_fn(model, mb, gen, rows=rows))
                loss.backward()
                if shards is not None:
                    shards.end_micro_batch()
                losses.append(loss.detach())
                metrics.append({k: v.detach() for k, v in m.items()})
        grads = (shards.take_grads() if shards is not None else
                 [p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in params])
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
            mean = {k: torch.mean(torch.stack([m[k] for m in metrics]))
                    for k in metrics[0]}
            return torch.mean(torch.stack(losses)), mean, grads
        return losses[0], metrics[0], grads

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model, sh = state.params, state.shards
        params = list(model.parameters())
        gnorm = reduce_max = None
        if sh is None:
            loss, metrics, grads = compute_grads(model, params, batch, seed,
                                                 state.opt.step)
        else:
            with sh.step():
                loss, metrics, grads = compute_grads(model, params, batch,
                                                     seed, state.opt.step, sh)
            loss = sh.mean(loss)
            metrics = {k: sh.mean(v) for k, v in metrics.items()}
            params, reduce_max = sh.local, sh.reduce_max
        comp = state.compression
        if comp is not None:
            grads, comp = compress_grads(grads, comp, reduce_max)
        if sh is not None:
            gnorm = sh.global_norm(grads)
        opt, opt_metrics = adamw_update(grads, state.opt, params, cfg,
                                        grad_norm=gnorm)
        for p in params:
            p.grad = None
        ema = state.ema
        if ema is not None:
            d = cfg.ema_decay
            with torch.no_grad():
                for e, p in zip(ema, params):
                    e.copy_(d * e + (1 - d) * p.to(e.dtype))
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(model, opt, comp, ema, sh), metrics

    return step


def _per_param(model: nn.Module):
    """of(seq) -> the map from each of the model's parameters to its entry
    in ``seq``, a list aligned with ``model.parameters()`` (a moment, an
    EMA copy)."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    return lambda seq: (lambda p: seq[index[id(p)]])


def _per_param_lists(state: TrainState):
    """(name, per-parameter list) of every part of the state a checkpoint
    holds beside the step, in the JAX ``TrainState``'s order."""
    out = [("params", state.shards.local if state.shards is not None
            else list(state.params.parameters())),
           ("opt/mu", state.opt.mu), ("opt/nu", state.opt.nu)]
    if state.compression is not None:
        out.append(("compression/error", state.compression.error))
    if state.ema is not None:
        out.append(("ema", state.ema))
    return out


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The tree a checkpoint stores, with the JAX ``TrainState``'s paths
    and layout (``params/…``, ``opt/step``, ``opt/mu/…``, ``opt/nu/…``,
    ``compression/error/…``, ``ema/…``; the JAX param tree of the model's
    family under each), so either package resumes from the other's
    training checkpoints.  On a sharded state the leaves are gathered
    whole (a collective: every rank calls it)."""
    from repro_torch.models.params import jax_tree

    model, sh = state.params, state.shards
    of = _per_param(model)
    tree: Dict[str, Any] = {"opt": {"step": np.asarray(state.opt.step,
                                                       np.int32)}}
    for name, seq in _per_param_lists(state):
        if sh is not None:
            seq = sh.gather_full(seq)
        sub = jax_tree(model, of(seq))
        node = tree
        *head, last = name.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = sub
    return tree


def load_state_tree(state: TrainState, arrays: Dict[str, np.ndarray]
                    ) -> TrainState:
    """Copy a checkpoint's ``path -> array`` map (:func:`state_tree`'s
    paths) into ``state`` in place; returns it with the restored step.
    On a sharded state each rank keeps its pieces of the whole arrays,
    whatever the number of ranks that wrote them (the reference's
    ``distributed/elastic.py::reshard_state``)."""
    from repro_torch.models.params import load_jax_arrays

    model, sh = state.params, state.shards
    of = _per_param(model)
    for name, seq in _per_param_lists(state):
        if sh is None:
            load_jax_arrays(model, arrays, name, of(seq))
            continue
        whole = [torch.empty(shape, dtype=t.dtype)
                 for shape, t in zip(sh.shapes, seq)]
        load_jax_arrays(model, arrays, name, of(whole))
        sh.scatter_full(whole, seq)
    opt = state.opt._replace(step=int(arrays["opt/step"]))
    return state._replace(opt=opt)


def run_train_loop(step_fn, state: TrainState, batch_iter, num_steps: int,
                   *, seed: int, checkpointer=None, checkpoint_every: int = 0,
                   log_every: int = 10, start_step: int = 0,
                   on_step: Optional[Callable[[int, Dict], None]] = None,
                   writer: bool = True) -> Tuple[TrainState, list]:
    """Host loop: data feeding, metrics, periodic (async) checkpoints of
    :func:`state_tree`; ``on_step(i, metrics)`` is called after every
    step (a caller's timer or logger).  On a sharded state every rank
    gathers the checkpoint's tree and only the ``writer`` saves it."""
    history = []
    t0 = time.time()
    for i in range(start_step, num_steps):
        batch = next(batch_iter)
        state, metrics = step_fn(state, batch, seed)
        if on_step is not None:
            on_step(i, metrics)
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            log.info("step %d loss %.4f (%.2fs)", i,
                     m.get("loss", float("nan")), time.time() - t0)
        if checkpointer is not None and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            tree = state_tree(state)
            if writer:
                checkpointer.save(i + 1, tree)
    return state, history

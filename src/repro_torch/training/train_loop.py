"""Train-step construction and the host-side training loop, as the JAX
package's ``training/train_loop.py`` composes them.

``make_train_step`` composes: loss -> gradients (``backward()``, with
optional micro-batch accumulation) -> AdamW (in place) -> optional EMA,
into one function whose signature is the same for every family::

    train_step(state, batch, seed) -> (state, metrics)

Randomness (the diffusion loss's noise and timesteps) comes from a CPU
``torch.Generator`` a micro-batch, seeded from (seed, step, micro):
the draws do not depend on the device, and a run resumed from a
checkpoint at step s draws what the uninterrupted run drew there.  The
reference restarts its key chain from the seed on resume instead, so
its resumed run draws other noise (a deliberate difference).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config.base import TrainConfig
from repro_torch.data.synthetic import batch_generator
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update)

log = logging.getLogger("repro_torch.train")


class TrainState(NamedTuple):
    """``params`` is the model, trained in place; ``opt`` holds the AdamW
    moments aligned with ``list(params.parameters())``; ``compression``
    is always None (no cross-pod int8 compression on one card); ``ema``
    a float copy of each parameter, or None."""

    params: nn.Module
    opt: AdamWState
    compression: None
    ema: Optional[List[torch.Tensor]]


def _no_compression(cfg: TrainConfig) -> None:
    if cfg.grad_compression:
        raise NotImplementedError(
            "grad_compression (the reference's int8 error-feedback "
            "compression, distributed/collectives.py) is not ported: "
            "ROADMAP queue 3")


def train_state_init(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """Zero moments and step 0; every parameter set to require grad."""
    _no_compression(cfg)
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    ema = ([p.detach().clone() for p in params] if cfg.ema_decay
           else None)
    return TrainState(model, adamw_init(params), None, ema)


LossFn = Callable[[nn.Module, Dict[str, torch.Tensor], torch.Generator],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_train_step(loss_fn: LossFn, cfg: TrainConfig) -> Callable:
    """loss_fn(model, batch, generator) -> (scalar loss, metrics dict).

    With ``grad_accum`` A > 1 each batch entry's leading dim B splits as
    ``reshape(A, B // A)``, so micro-batch i is rows [i·B/A, (i+1)·B/A);
    the float32 gradients of the micro-batches are summed, then divided
    by A, and the loss and metrics averaged, as the reference's scan
    does.  Gradients are taken with grad mode on whatever the caller's
    mode."""
    _no_compression(cfg)
    accum = max(cfg.grad_accum, 1)

    def compute_grads(model, params, batch, seed, step):
        for p in params:
            p.grad = None
        if accum > 1:
            sizes = {v.shape[0] for v in batch.values()}
            if len(sizes) != 1 or next(iter(sizes)) % accum:
                raise ValueError(f"batch sizes {sorted(sizes)} do not split "
                                 f"into grad_accum={accum} micro-batches")
            per = next(iter(sizes)) // accum
            micros = [{k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                      for i in range(accum)]
        else:
            micros = [batch]
        losses, metrics = [], []
        with torch.enable_grad():
            for i, mb in enumerate(micros):
                loss, m = loss_fn(model, mb, batch_generator(seed, step, i))
                loss.backward()
                losses.append(loss.detach())
                metrics.append({k: v.detach() for k, v in m.items()})
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
            mean = {k: torch.mean(torch.stack([m[k] for m in metrics]))
                    for k in metrics[0]}
            return torch.mean(torch.stack(losses)), mean, grads
        return losses[0], metrics[0], grads

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.params
        params = list(model.parameters())
        loss, metrics, grads = compute_grads(model, params, batch, seed,
                                             state.opt.step)
        opt, opt_metrics = adamw_update(grads, state.opt, params, cfg)
        for p in params:
            p.grad = None
        ema = state.ema
        if ema is not None:
            d = cfg.ema_decay
            with torch.no_grad():
                for e, p in zip(ema, params):
                    e.copy_(d * e + (1 - d) * p.to(e.dtype))
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(model, opt, None, ema), metrics

    return step


def _per_param(model: nn.Module):
    """of(seq) -> the map from each of the model's parameters to its entry
    in ``seq``, a list aligned with ``model.parameters()`` (a moment, an
    EMA copy)."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    return lambda seq: (lambda p: seq[index[id(p)]])


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The tree a checkpoint stores, with the JAX ``TrainState``'s paths
    and layout (``params/…``, ``opt/step``, ``opt/mu/…``, ``opt/nu/…``,
    ``ema/…``; the JAX param tree of the model's family under each), so
    either package resumes from the other's training checkpoints."""
    from repro_torch.models.params import jax_tree

    model = state.params
    of = _per_param(model)
    tree = {"params": jax_tree(model),
            "opt": {"step": np.asarray(state.opt.step, np.int32),
                    "mu": jax_tree(model, of(state.opt.mu)),
                    "nu": jax_tree(model, of(state.opt.nu))}}
    if state.ema is not None:
        tree["ema"] = jax_tree(model, of(state.ema))
    return tree


def load_state_tree(state: TrainState, arrays: Dict[str, np.ndarray]
                    ) -> TrainState:
    """Copy a checkpoint's ``path -> array`` map (:func:`state_tree`'s
    paths) into ``state`` in place; returns it with the restored step."""
    from repro_torch.models.params import load_jax_arrays

    model = state.params
    of = _per_param(model)
    load_jax_arrays(model, arrays, "params")
    load_jax_arrays(model, arrays, "opt/mu", of(state.opt.mu))
    load_jax_arrays(model, arrays, "opt/nu", of(state.opt.nu))
    if state.ema is not None:
        load_jax_arrays(model, arrays, "ema", of(state.ema))
    opt = state.opt._replace(step=int(arrays["opt/step"]))
    return state._replace(opt=opt)


def run_train_loop(step_fn, state: TrainState, batch_iter, num_steps: int,
                   *, seed: int, checkpointer=None, checkpoint_every: int = 0,
                   log_every: int = 10, start_step: int = 0,
                   on_step: Optional[Callable[[int, Dict], None]] = None
                   ) -> Tuple[TrainState, list]:
    """Host loop: data feeding, metrics, periodic (async) checkpoints of
    :func:`state_tree`; ``on_step(i, metrics)`` is called after every
    step (a caller's timer or logger)."""
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
            checkpointer.save(i + 1, state_tree(state))
    return state, history

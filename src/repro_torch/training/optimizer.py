"""AdamW and its learning-rate schedules, as the JAX package's
``training/optimizer.py`` computes them.

The moments are float32 whatever the parameter dtype.  Parameters are a
list of tensors (``list(model.parameters())``) and are updated in place
under ``no_grad``: the JAX update returns new arrays, the port keeps one
copy of the weights.  The arithmetic is the reference's ``upd``, written
with ``torch._foreach_*`` ops: clipping by the global norm, the bias
corrections, and decoupled weight decay inside the step's ``delta``
(``torch.optim.AdamW`` places ε and the decay elsewhere, and rounds
differently)."""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.utils.pytree import tree_global_norm


class AdamWState(NamedTuple):
    step: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adamw_init(params: List[torch.Tensor]) -> AdamWState:
    def zeros():
        return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params]

    return AdamWState(step=0, mu=zeros(), nu=zeros())


def lr_schedule(cfg: TrainConfig) -> Callable[[int], torch.Tensor]:
    """step -> the learning rate, a float32 scalar: linear warmup to
    ``learning_rate`` over ``warmup_steps``, then constant, linear decay
    or cosine decay to 0 at ``total_steps``."""
    peak = cfg.learning_rate
    warm = max(cfg.warmup_steps, 1)
    total = max(cfg.total_steps, warm + 1)

    def f(step) -> torch.Tensor:
        s = torch.as_tensor(step, dtype=torch.float32)
        warmup = peak * s / warm
        if cfg.schedule == "constant":
            after = torch.full_like(warmup, peak)
        else:
            frac = torch.clip((s - warm) / (total - warm), 0.0, 1.0)
            if cfg.schedule == "linear":
                after = peak * (1.0 - frac)
            else:  # cosine; the cosine of the float32 argument rounded
                # once from float64, as XLA's float32 cos gives it
                cos = torch.cos((math.pi * frac).double()).float()
                after = 0.5 * peak * (1.0 + cos)
        return torch.where(s < warm, warmup, after)

    return f


# The float32 temporaries of one update pass cover at most this many
# elements (1 GiB): passes over the whole tree would add two float32
# copies of it, 36 GB beside gemma3-4b's 72.8 GB of params, gradients
# and moments.  Read at call time.
_GROUP_ELEMS = 1 << 28


def _groups(sizes: List[int]) -> Iterator[List[Tuple[int, int, int]]]:
    """Consecutive (leaf, start, stop) ranges of the flattened leaves,
    ``_GROUP_ELEMS`` elements a group (the last may hold fewer); a leaf
    larger than a group spans several."""
    group: List[Tuple[int, int, int]] = []
    room = _GROUP_ELEMS
    for i, n in enumerate(sizes):
        start = 0
        while start < n:
            stop = min(n, start + room)
            group.append((i, start, stop))
            room -= stop - start
            start = stop
            if room == 0:
                yield group
                group, room = [], _GROUP_ELEMS
    if group:
        yield group


def _update_pass(g, mu, nu, params, clip, lr, bc1, bc2, cfg: TrainConfig):
    """The reference's ``upd`` on aligned lists of equal-size tensors:
    each pass is one of its ops, in its order, so the roundings agree;
    the temporaries are reused in place (at most two copies of ``g``'s
    size live at once)."""
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    g = torch._foreach_mul([x.float() for x in g], clip)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(g, g)
    torch._foreach_mul_(g, 1 - b2)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, g)
    del g
    delta = torch._foreach_div(mu, float(bc1))
    denom = torch._foreach_div(nu, float(bc2))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(delta, denom)
    del denom
    p32 = [p.float() for p in params]
    torch._foreach_add_(delta, torch._foreach_mul(p32, wd))
    torch._foreach_mul_(delta, float(lr))
    torch._foreach_sub_(p32, delta)
    del delta
    for p, n in zip(params, p32):
        if n is not p:  # a parameter below float32: round back to it
            p.copy_(n)


@torch.no_grad()
def adamw_update(grads: List[Optional[torch.Tensor]], state: AdamWState,
                 params: List[torch.Tensor], cfg: TrainConfig,
                 grad_norm: Optional[torch.Tensor] = None):
    """One AdamW step with global-norm clipping, on ``params`` in place.
    Returns (new state, metrics): ``grad_norm`` (before clipping) and
    ``lr``, float32 scalars on the gradients' device.  ``grad_norm``
    given is the whole tree's norm when ``grads`` and ``params`` are one
    rank's pieces of it (``distributed.fsdp``).

    The norm and the clip factor cover the whole tree; the update runs
    over groups of ``_GROUP_ELEMS`` elements (flat ranges of the
    contiguous leaves), each pass elementwise, so the result is the
    whole-tree update's bit for bit.  ``grads`` is consumed: once a
    leaf is updated its entry is set to None and its parameter's
    ``.grad`` dropped."""
    if not params:
        raise ValueError("adamw_update needs at least one parameter")
    gnorm = tree_global_norm(grads) if grad_norm is None else grad_norm
    if cfg.grad_clip > 0:
        clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    else:
        clip = torch.ones((), device=gnorm.device)
    step = state.step + 1
    lr = lr_schedule(cfg)(step)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.beta1, dtype=torch.float32),
                          float(step))
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.beta2, dtype=torch.float32),
                          float(step))
    flat = [(g.reshape(-1), m.view(-1), v.view(-1), p.view(-1))
            for g, m, v, p in zip(grads, state.mu, state.nu, params)]
    for group in _groups([p.numel() for p in params]):
        pieces = [[t[a:b] for t in flat[i]] for i, a, b in group]
        _update_pass(*zip(*pieces), clip, lr, bc1, bc2, cfg)
        del pieces
        for i, _, b in group:
            if b == params[i].numel():  # the leaf's last range: free it
                flat[i] = grads[i] = params[i].grad = None
    metrics: Dict[str, torch.Tensor] = {
        "grad_norm": gnorm, "lr": lr.to(gnorm.device)}
    return AdamWState(step, state.mu, state.nu), metrics

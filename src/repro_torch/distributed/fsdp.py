"""Parameters, gradients and optimizer state sharded over the ranks'
batch axes: the reference's FSDP on ``embed`` (``param_rules``), for
training on several processes.

Each parameter's shard dim is the dim its rule-table spec
(``spec_from_axes`` of its logical axes, ``models.params.param_axes``)
puts on the batch axes; a parameter without one, or whose dim the ranks
do not divide, is replicated.  Between steps every rank holds only its
pieces: the float32 master parameters, the AdamW moments, the
compression residual and the EMA.

Within a step the model is whole one block at a time.  The blocks are
the modules the model's forward runs through ``models.common.remat_call``
(:func:`block_units`); the rest (embeddings, heads, conditioning) is the
root, gathered whole for the step.  A block's parameters are gathered
(``all_gather_into_tensor``) just before it runs and freed just after;
the gradient arriving at its outputs gathers them again for its
backward pass (and its recomputation under remat).  Once every one of
its parameters has accumulated its gradient, the whole gradients are
reduce-scattered (``reduce_scatter_tensor``; replicated ones
all-reduced) into this rank's float32 gradient pieces and freed with the
parameters.  After each micro-batch's backward pass whatever is left
(the root, a block with a parameter that took no gradient) is reduced
the same way.

A rank's peak is thus its pieces, 16/N bytes a parameter with AdamW
(params, two moments, gradients; the residual and the EMA 4/N more each),
plus the root's whole parameters and gradients, plus one or two blocks'
whole parameters and gradients.  Without remat the backward pass also
keeps what the forward saved, the bfloat16 casts of the weights among
it.  At one rank the pieces are the parameters themselves, every
collective on them is the identity and the step is the unsharded one.

On a rank mesh with a ``model`` axis above 1 the pieces are 2-D: a
parameter's spec may also put a dim on ``model`` (``heads``, ``kv``,
``mlp``, ``vocab``, ``expert``), and that piece is never gathered here.
"Whole" above then means whole over the batch axes: the gathers and the
reductions run over the batch group (the ranks that share this rank's
model index), and the model code computes with the model pieces
(``distributed.tensor_parallel``, where the model axis's gradients are
combined inside autograd).  With one rank on the batch axes the model
pieces are the parameters themselves.  The clip norm counts every
element once across both axes, and :meth:`ParamShards.gather_full` /
:meth:`ParamShards.scatter_full` go between pieces and whole tensors
over both.
"""

from __future__ import annotations

import contextlib
import itertools
import weakref
from typing import List, Optional, Sequence

import torch
from torch import nn

from repro_torch.distributed.elastic import local_piece
from repro_torch.distributed.sharding import (axis_size, batch_axes,
                                              param_rules, spec_from_axes)
from repro_torch.distributed.tensor_parallel import (all_gather_dim,
                                                     all_reduce_,
                                                     reduce_scatter_dim)

__all__ = ["ParamShards", "block_units"]


def _flat(entry):
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def block_units(model: nn.Module) -> List[nn.Module]:
    """The model's blocks: every entry of an ``nn.ModuleList`` that holds
    no ``ModuleList`` itself (a transformer's layers, a UNet level's res
    and attention blocks, an EfficientNet stage's MBConvs), the modules
    each family's forward runs through ``remat_call``."""
    out = []
    for m in model.modules():
        if isinstance(m, nn.ModuleList):
            out.extend(c for c in m if not any(
                isinstance(x, nn.ModuleList) for x in c.modules()))
    return out


def _move(model: nn.Module, device: torch.device) -> None:
    """``model.to(device)`` unless its parameters and buffers are all there
    already (a dry run's fake parameters cannot be moved in place)."""
    if any(t.device != device for t in itertools.chain(model.parameters(),
                                                      model.buffers())):
        model.to(device)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


class ParamShards:
    """The pieces of a model's parameters on this rank of a
    :class:`~repro_torch.launch.mesh.RankMesh`, and the per-block
    gathers and gradient reductions of a step (:meth:`step`).  The model
    may come on the CPU: the pieces are made on the mesh's device."""

    def __init__(self, model, mesh, rules=None):
        from repro_torch.models.params import param_axes

        import torch.distributed as dist

        self._dist = dist
        self.model = model
        self.mesh = mesh
        self.device = mesh.device
        self.params = list(model.parameters())
        self.group = mesh.batch_group()
        bd = batch_axes(mesh)
        self.n = axis_size(mesh, bd)
        self.index = mesh.batch_index()
        self.m = mesh.model_size
        self.model_group = mesh.model_group()
        self.model_index = mesh.model_index()
        rules = rules or param_rules(mesh)
        self.shapes = [tuple(p.shape) for p in self.params]
        self.coords = mesh.coordinate()
        self.specs = [spec_from_axes(axes, rules, tuple(p.shape), mesh)
                      for p, axes in zip(self.params, param_axes(model))]
        # The dim each collective runs along: the one on the batch axes;
        # and the dim on ``model``, whose pieces stay local.
        self.dims: List[Optional[int]] = [
            next((i for i, e in enumerate(spec) if set(_flat(e)) & set(bd)), None)
            for spec in self.specs]
        self.mdims: List[Optional[int]] = [
            next((i for i, e in enumerate(spec) if "model" in _flat(e)), None)
            for spec in self.specs]
        self.grads: Optional[List[torch.Tensor]] = None
        if self.n == 1:
            if self.m > 1:
                with torch.no_grad():
                    for i, p in enumerate(self.params):
                        p.data = self.piece(p.detach(), i).to(self.device,
                                                              copy=True)
            _move(model, self.device)
            self.local = list(model.parameters())
            return
        with torch.no_grad():
            self.local = [self.piece(p.detach(), i).to(self.device, copy=True)
                          for i, p in enumerate(self.params)]
        # Each parameter's shape while it is whole over the batch axes.
        self.block_shapes = [
            tuple(s * (self.n if k == d else 1) for k, s in enumerate(x.shape))
            for x, d in zip(self.local, self.dims)]
        index = {id(p): i for i, p in enumerate(self.params)}
        me = weakref.ref(self)  # the hooks keep neither this nor its group
        self.units = {}   # id(block) -> its parameters' indices
        owned = set()
        for m in block_units(model):
            idx = [index[id(p)] for p in m.parameters()
                   if index[id(p)] not in owned]
            owned.update(idx)
            self.units[id(m)] = idx
            for i in idx:
                self.params[i].register_post_accumulate_grad_hook(
                    lambda p, i=i: me() and me()._accumulated(i))
        self.root = [i for i in range(len(self.params)) if i not in owned]
        self._whole = set()    # indices of the parameters now whole
        self._block_of = {}    # index -> the parameters of its block's call
        self._left = {}        # a call's parameters -> gradients to come
        self._reduced = set()  # indices reduced in this micro-batch
        self._active = False
        self._release(range(len(self.params)))
        _move(model, self.device)  # buffers; the parameters are empty there

    # -- pieces and whole tensors ------------------------------------------

    def piece(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's piece of parameter ``i``'s whole tensor ``t`` under
        its spec (a view; ``distributed.elastic.local_piece``)."""
        return local_piece(t, self.specs[i], self.mesh, self.coords)

    def _gather(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """A piece gathered over the batch axes (its model piece)."""
        d = self.dims[i]
        if d is None or self.n == 1:
            return x
        return all_gather_dim(x, self.group, self.n, d)

    @torch.no_grad()
    def _gather_params(self, idx: Sequence[int]) -> None:
        for i in idx:
            if i not in self._whole:
                self.params[i].data = self._gather(self.local[i], i)
                self._whole.add(i)

    def _release(self, idx: Sequence[int]) -> None:
        for i in idx:
            p = self.params[i]
            p.data = torch.empty(0, dtype=p.dtype, device=self.device)
            self._whole.discard(i)

    @torch.no_grad()
    def _reduce(self, idx: Sequence[int]) -> None:
        """Add the ranks' sum of each whole gradient's piece to this
        rank's gradient pieces and free the whole gradients."""
        for i in idx:
            p = self.params[i]
            g = p.grad if p.grad is not None else torch.zeros(
                self.block_shapes[i], dtype=p.dtype, device=self.device)
            p.grad = None
            self._reduced.add(i)
            d = self.dims[i]
            if d is None:
                all_reduce_(g, self.group)
            else:
                g = reduce_scatter_dim(g, self.group, self.n, d)
            self.grads[i].add_(g)

    def _full(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """A piece gathered over the batch axes, then over ``model``."""
        x = self._gather(x, i)
        d = self.mdims[i]
        if d is None or self.m == 1:
            return x
        return all_gather_dim(x, self.model_group, self.m, d)

    def gather_full(self, pieces: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole CPU copies of per-parameter pieces (a moment, the EMA):
        a collective every rank calls."""
        return [self._full(x, i).cpu() for i, x in enumerate(pieces)]

    def scatter_full(self, whole: List[torch.Tensor],
                     into: List[torch.Tensor]) -> None:
        """Copy this rank's piece of each whole tensor into ``into``."""
        with torch.no_grad():
            for i, (w, t) in enumerate(zip(whole, into)):
                t.copy_(self.piece(w, i))

    # -- a step --------------------------------------------------------------

    @contextlib.contextmanager
    def step(self):
        """A step's scope: the root whole and zero gradient pieces; the
        blocks gathered as they run (``models.common.block_hook``); on
        leaving, every whole tensor freed."""
        if self.n == 1:
            yield
            return
        from repro_torch.models.common import block_hook

        self.grads = [torch.zeros_like(x) for x in self.local]
        self._gather_params(self.root)
        self._active = True
        try:
            with block_hook(self._run_block):
                yield
        finally:
            self._active = False
            for p in self.params:
                p.grad = None
            self._left.clear()
            self._reduced.clear()
            self._release(list(self._whole))

    def end_micro_batch(self) -> None:
        """After a micro-batch's backward pass: reduce the gradients not
        yet reduced and free the blocks still whole."""
        if self.n == 1:
            return
        self._reduce([i for i in range(len(self.params))
                      if i not in self._reduced])
        self._reduced.clear()
        self._left.clear()
        self._release([i for i in self._whole if i not in self.root])

    def take_grads(self) -> List[torch.Tensor]:
        """The step's gradients so far, summed over its micro-batches: at
        one rank the parameters' own, else this rank's pieces averaged
        over the ranks."""
        if self.n == 1:
            return [p.grad if p.grad is not None else torch.zeros_like(p)
                    for p in self.params]
        grads, self.grads = self.grads, None
        torch._foreach_div_(grads, float(self.n))
        return grads

    def _run_block(self, call, modules):
        """``models.common.block_hook``'s hook: the blocks among
        ``modules`` whole while ``call`` runs, and again when the
        gradient reaches its outputs."""
        idx = tuple(i for m in modules for i in self.units.get(id(m), ()))
        if not idx:
            return call()
        self._gather_params(idx)
        out = call()
        self._release(idx)
        if torch.is_grad_enabled():
            need = sum(self.params[i].requires_grad for i in idx)

            def before_backward(grad):
                self._gather_params(idx)
                self._left.setdefault(idx, need)
                return grad

            for i in idx:
                self._block_of[i] = idx
            for t in _tensors(out):
                if t.requires_grad:
                    t.register_hook(before_backward)
        return out

    def _accumulated(self, i: int) -> None:
        """Parameter ``i``'s gradient is accumulated: the last of its
        block's reduces and frees the block."""
        idx = self._block_of.get(i)
        if not self._active or idx not in self._left:
            return
        self._left[idx] -= 1
        if self._left[idx] == 0:
            del self._left[idx]
            self._reduce(idx)
            self._release(idx)

    # -- the step's other collectives ----------------------------------------

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """A scalar metric averaged over the batch axes' ranks (the model
        group's ranks hold the same value)."""
        x = x.detach().clone()
        if self.group is None:
            return x
        return all_reduce_(x, self.group) / self.n

    def reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum over every rank (the compression scale's ``max|g +
        e|`` of a whole tensor, whose pieces lie on both axes)."""
        return all_reduce_(x.clone(), self._dist.group.WORLD,
                           self._dist.ReduceOp.MAX)

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The float32 L2 norm of the whole gradient tree from its pieces:
        the norm of every rank's per-piece norms (a gradient replicated
        over an axis counted on that axis's first rank only), in the
        order ``utils.pytree.tree_global_norm`` takes at one rank."""
        norms = torch.stack(torch._foreach_norm([g.float() for g in grads]))
        if self.index != 0 or self.model_index != 0:
            keep = torch.tensor(
                [(d is not None or self.index == 0)
                 and (md is not None or self.model_index == 0)
                 for d, md in zip(self.dims, self.mdims)],
                device=norms.device)
            norms = torch.where(keep, norms, torch.zeros_like(norms))
        world = self._dist.get_world_size()
        every = all_gather_dim(norms, self._dist.group.WORLD, world, 0)
        return torch.linalg.vector_norm(every)

"""Tensor parallelism over the ``model`` axis of a rank mesh: the port's
own explicit design for what the reference leaves to GSPMD under its
rule tables (``heads``, ``kv``, ``mlp``, ``vocab`` and ``expert`` on
``model``; ``seq`` too with ``train.seq_parallel``).

Each rank holds its piece of every parameter that the rule tables put
on ``model`` (``distributed.fsdp``; ``spec_from_axes``' pieces, so a
piece may end mid-head) and computes a layer as a *region*:

* the region's input is whole on every rank of the model group
  (:meth:`TensorParallel.enter`: the identity, whose backward pass sums
  the ranks' input gradients; under sequence parallelism the all-gather
  of the ranks' sequence pieces, whose backward pass reduce-scatters);
* inside, each rank computes its share: column-parallel products on its
  columns, the attention of its query heads, its experts, its vocab
  slice.  Every gradient inside a region is this rank's part of the
  whole one: a weight piece that only this rank uses has its whole
  gradient, a weight replicated over ``model`` is taken through
  :meth:`TensorParallel.copy_to` (its gradient summed over the group),
  and a weight whose piece is not what this rank computes with (a
  piece that ends mid-head) is all-gathered for the region
  (:meth:`TensorParallel.take`), its gradient reduce-scattered back;
* the region's output is the sum of the ranks' partial outputs
  (:meth:`TensorParallel.leave`: an all-reduce, whose backward pass is
  the identity; under sequence parallelism a reduce-scatter over the
  sequence, whose backward pass all-gathers).  A value that every rank
  computes whole and that leaves the region unsummed (the router's aux
  loss) goes through :meth:`TensorParallel.once`, so its gradient enters
  the region on one rank only.

Where the query heads do not divide the group, attention is a *query-row
region* instead (the reference's ``_attn_seq_fallback``: ``attn_seq`` on
``model``): its input is whole as above, each rank computes every head
for its range of query rows (:meth:`TensorParallel.span` of the
sequence) against the whole K and V, the projection weights are taken
whole (:meth:`TensorParallel.take`: gathered, their gradients
reduce-scattered back), and the ranks' output rows are concatenated
(:meth:`TensorParallel.join`: an all-gather, whose backward pass keeps
this rank's rows of the gradient, which every rank holds whole).

The activation collectives are exact (no compression).  On a gloo group
CUDA tensors go through host memory, as ``distributed.spmd`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

__all__ = ["TensorParallel", "all_gather_dim", "all_reduce_",
           "reduce_scatter_dim", "span"]


def _gloo(group) -> bool:
    import torch.distributed as dist

    return str(dist.get_backend(group)).lower() == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce_(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """``x`` reduced over ``group`` in place (sum by default); a CUDA
    tensor on a gloo group goes through pinned host memory."""
    import torch.distributed as dist

    op = dist.ReduceOp.SUM if op is None else op
    if x.is_cuda and _gloo(group):
        h = _host(x)
        dist.all_reduce(h, op=op, group=group)
        x.copy_(h)
        return x
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` concatenated along ``dim`` in group-rank
    order (``all_gather_into_tensor``; no gradient)."""
    import torch.distributed as dist

    y = x.detach().movedim(dim, 0).contiguous()
    shape = (n * y.shape[0],) + tuple(y.shape[1:])
    if y.is_cuda and _gloo(group):
        out = torch.empty(shape, dtype=y.dtype, pin_memory=True)
        dist.all_gather_into_tensor(out, _host(y), group=group)
        out = out.to(y.device)
    else:
        out = torch.empty(shape, dtype=y.dtype, device=y.device)
        dist.all_gather_into_tensor(out, y, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, group, n: int, dim: int
                       ) -> torch.Tensor:
    """This rank's 1/n piece along ``dim`` of the sum of the ranks' ``x``
    (``reduce_scatter_tensor``; no gradient)."""
    import torch.distributed as dist

    y = x.detach().movedim(dim, 0).contiguous()
    shape = (y.shape[0] // n,) + tuple(y.shape[1:])
    if y.is_cuda and _gloo(group):
        piece = torch.empty(shape, dtype=y.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(piece, _host(y), op=dist.ReduceOp.SUM,
                                   group=group)
        piece = piece.to(y.device)
    else:
        piece = torch.empty(shape, dtype=y.dtype, device=y.device)
        dist.reduce_scatter_tensor(piece, y, op=dist.ReduceOp.SUM,
                                   group=group)
    return piece.movedim(0, dim).contiguous()


def span(n: int, size: int, index: int) -> Tuple[int, int]:
    """Rank ``index``'s range of ``n`` items split ``size`` ways (the
    even piece where ``size`` divides ``n``)."""
    return index * n // size, (index + 1) * n // size


class _CopyTo(torch.autograd.Function):
    """Forward the identity; backward the sum over the group."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.tp.group), None


class _ReduceFrom(torch.autograd.Function):
    """Forward the sum over the group; backward the identity."""

    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_(x.contiguous().clone(), tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Forward the all-gather along ``dim``; backward the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return all_gather_dim(x, tp.group, tp.size, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.tp.group, ctx.tp.size,
                                  ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    """Forward the reduce-scatter along ``dim``; backward the all-gather."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return reduce_scatter_dim(x, tp.group, tp.size, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.tp.group, ctx.tp.size,
                              ctx.dim), None, None


class _Split(torch.autograd.Function):
    """Forward this rank's piece along ``dim`` of a whole tensor; backward
    the all-gather of the pieces' gradients."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        c = x.shape[dim] // tp.size
        return x.narrow(dim, tp.index * c, c).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.tp.group, ctx.tp.size,
                              ctx.dim), None, None


class _Join(torch.autograd.Function):
    """Forward the ranks' :func:`span` pieces of ``n`` items along ``dim``
    concatenated (padded to the largest for the all-gather); backward this
    rank's piece of the gradient, whole and equal on every rank."""

    @staticmethod
    def forward(ctx, x, tp, dim, n):
        ctx.tp, ctx.dim, ctx.n = tp, dim, n
        most = -(-n // tp.size)
        pad = list(x.shape)
        pad[dim] = most - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim) if pad[dim] else x
        every = all_gather_dim(x, tp.group, tp.size, dim)
        return torch.cat([every.narrow(dim, j * most, hi - lo) for j, (lo, hi)
                          in enumerate(span(n, tp.size, j)
                                       for j in range(tp.size))], dim)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.tp.span(ctx.n)
        return g.narrow(ctx.dim, lo, hi - lo).contiguous(), None, None, None


class _Once(torch.autograd.Function):
    """Forward the identity; backward the gradient on the group's first
    rank and zeros on the others."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.index = index
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.index == 0 else torch.zeros_like(g)), None


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's place on the ``model`` axis: the model ``group``, its
    ``size`` and this rank's ``index`` in it, and whether the residual
    stream is sharded on its sequence dim (``seq_parallel``)."""

    group: Any
    size: int
    index: int
    seq_parallel: bool = False

    # -- the primitives ------------------------------------------------------

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (whole on every rank), its gradient summed over the
        group."""
        return _CopyTo.apply(x, self)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of the ranks' partial ``x``."""
        return _ReduceFrom.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' pieces of ``x`` concatenated along ``dim``; the
        gradient reduce-scattered back to the pieces."""
        return _Gather.apply(x, self, dim)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece along ``dim`` of the sum of the ranks'
        partial ``x``."""
        return _Scatter.apply(x, self, dim)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece along ``dim`` of ``x``, whole on every rank."""
        return _Split.apply(x, self, dim)

    def join(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """A region's output from this rank's :meth:`span` piece of ``n``
        items along ``dim``: the ranks' pieces concatenated, whole on every
        rank; the gradient, whole on every rank, narrowed to the piece."""
        return _Join.apply(x, self, dim, n)

    def once(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (whole and equal on every rank), its gradient kept on the
        group's first rank only."""
        return _Once.apply(x, self.index)

    def reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the group (no gradient)."""
        import torch.distributed as dist

        return all_reduce_(x.detach().contiguous().clone(), self.group,
                           dist.ReduceOp.MAX)

    def span(self, n: int) -> Tuple[int, int]:
        """This rank's range of ``n`` items split over the group."""
        return span(n, self.size, self.index)

    def attention_split(self, n_heads: int, n: int, rows: bool
                        ) -> Tuple[int, int, int, int]:
        """This rank's heads [h0, h1) and query rows [r0, r1) of an
        attention over ``n`` tokens: its run of the heads and every row,
        or with ``rows`` (the rules' ``attn_seq`` on ``model``) every head
        and its :meth:`span` of the rows."""
        if rows:
            return (0, n_heads) + self.span(n)
        if n_heads % self.size:
            raise ValueError(f"{n_heads} heads do not divide a model axis of "
                             f"{self.size}: the rules' attn_seq fallback "
                             f"(sharding.attn_seq_fallback) splits query rows")
        return self.span(n_heads) + (0, n)

    # -- regions ---------------------------------------------------------------

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A region's input (B, S, d): the whole ``x`` with its gradient
        summed over the group, or under sequence parallelism the ranks'
        sequence pieces all-gathered."""
        if self.seq_parallel:
            return self.gather(x, 1)
        return self.copy_to(x)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """A region's output (B, S, d): the sum of the ranks' partial
        ``x``, or under sequence parallelism this rank's sequence piece
        of it."""
        if self.seq_parallel:
            return self.scatter(x, 1)
        return self.reduce_from(x)

    def norm_scale(self, scale: torch.Tensor) -> torch.Tensor:
        """A norm's scale on the residual stream: under sequence
        parallelism each rank normalises its own tokens, so the scale's
        gradient is summed over the group."""
        return self.copy_to(scale) if self.seq_parallel else scale

    def take(self, w: torch.Tensor, dim: int, whole: int, lo: int,
             hi: int) -> torch.Tensor:
        """Items [lo, hi) along ``dim`` of a weight of ``whole`` items
        there, for use inside a region, from ``w``: this rank's model
        piece (used as it is when it is exactly those items, else
        all-gathered over the group for the region) or the whole weight
        where the rule tables replicate it over ``model`` (its gradient
        then summed over the group)."""
        n = w.shape[dim]
        if n == whole:
            return self.copy_to(w).narrow(dim, lo, hi - lo)
        if (lo, hi) == (self.index * n, (self.index + 1) * n):
            return w
        return self.gather(w, dim).narrow(dim, lo, hi - lo)

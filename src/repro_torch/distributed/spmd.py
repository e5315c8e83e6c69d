"""One controller, many shards: the port's ``shard_map`` and the
collectives of ``jax.lax`` that the attention pipeline uses.

:func:`shard_map` splits global tensors by :class:`P` specs over a
:class:`~repro_torch.launch.mesh.Mesh`, runs the body once per mesh
coordinate, each in a thread of its own, bound to that coordinate's
device and (on a card) a CUDA stream of its own, and gathers the
outputs back onto the first device.  Inside the body,
:func:`axis_index`, :func:`ppermute`, :func:`all_gather`, :func:`psum`,
:func:`pmean` and :func:`pmax` behave as their ``jax.lax`` namesakes
over one mesh axis (``psum`` and ``pmean`` also over a tuple of axes): each is a barrier among the shards of that axis, then a hand-off
of the tensors, copied to the receiver's device when it is another one.
So the same code runs as several CPU shards, as several shards on one
card, and as one shard per card; no ``torch.distributed`` process group
is needed on one host.

Ordering on a card: the shard streams wait for the caller's stream
before they start, a tensor handed to another shard carries an event of
its sender's stream that the receiver's stream waits on (and is kept
alive by ``record_stream`` or by the call until it ends), and the
caller's streams wait for every shard before the outputs are gathered.
An exception in one shard aborts every barrier, so the others stop at
their next collective, and reaches the caller; it never hangs.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["P", "all_gather", "axis_index", "axis_size", "first_shard",
           "pmax", "pmean", "ppermute", "psum", "shard_map"]


class P(tuple):
    """A partition spec: one entry a dim, None (replicated), a mesh axis
    name, or a tuple of names (row-major over them), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


_CTX = threading.local()


@dataclasses.dataclass
class _Shard:
    coords: Dict[str, int]
    device: torch.device
    stream: Optional["torch.cuda.Stream"]
    run: "_Run"
    seq: Dict[Tuple, int] = dataclasses.field(default_factory=dict)


class _Run:
    """The shared state of one :func:`shard_map` call: barriers and the
    hand-off board of each axis group, and the failure flag."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.lock = threading.Lock()
        self.barriers: Dict[Tuple, threading.Barrier] = {}
        self.board: Dict[Tuple, List] = {}
        self.failed = False

    def barrier(self, group: Tuple, n: int) -> threading.Barrier:
        with self.lock:
            b = self.barriers.get(group)
            if b is None:
                b = self.barriers[group] = threading.Barrier(n)
                if self.failed:
                    b.abort()
            return b

    def abort(self) -> None:
        with self.lock:
            self.failed = True
            for b in self.barriers.values():
                b.abort()


def _ctx() -> _Shard:
    ctx = getattr(_CTX, "shard", None)
    if ctx is None:
        raise RuntimeError("a collective was called outside shard_map")
    return ctx


def axis_index(axis: str) -> int:
    """This shard's index along mesh axis ``axis``."""
    return _ctx().coords[axis]


def axis_size(axis: str) -> int:
    return _ctx().run.mesh.shape[axis]


def first_shard() -> bool:
    """Is the caller the shard at mesh coordinate 0 on every axis?"""
    return all(i == 0 for i in _ctx().coords.values())


def _exchange(axis: str, x: torch.Tensor) -> List[torch.Tensor]:
    """Every shard of this shard's ``axis`` group deposits ``x``; after
    the group's barrier each gets all of them, in axis order, on its own
    device and ordered after their producers on its stream."""
    ctx = _ctx()
    run = ctx.run
    n = run.mesh.shape[axis]
    me = ctx.coords[axis]
    group = (axis,) + tuple(sorted((a, i) for a, i in ctx.coords.items()
                                   if a != axis))
    seq = ctx.seq.get(group, 0)
    ctx.seq[group] = seq + 1
    event = None
    if ctx.stream is not None:
        event = torch.cuda.Event()
        event.record(ctx.stream)
    with run.lock:
        slots = run.board.setdefault(group + (seq,), [None] * n)
        slots[me] = (x, event)
    run.barrier(group, n).wait()
    with run.lock:
        slots = list(run.board[group + (seq,)])
    return [_receive(ctx, t, ev) for t, ev in slots]


def _receive(ctx: _Shard, t: torch.Tensor, event) -> torch.Tensor:
    if ctx.stream is None:
        return t if t.device == ctx.device else t.to(ctx.device)
    if t.device == ctx.device:
        ctx.stream.wait_event(event)
        t.record_stream(ctx.stream)
        return t
    # Another card: the copy runs on the source card's current stream of
    # this thread, which must first wait for the sender.
    src = torch.cuda.current_stream(t.device)
    src.wait_event(event)
    t.record_stream(src)
    return t.to(ctx.device)


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: shard ``dst`` receives shard ``src``'s ``x``
    for each (src, dst) pair; a shard that receives nothing gets zeros."""
    got = _exchange(axis, x)
    me = axis_index(axis)
    for src, dst in perm:
        if dst == me:
            return got[src]
    return torch.zeros_like(x)


def all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Tiled ``jax.lax.all_gather``: the group's ``x`` concatenated
    along ``dim`` in axis order."""
    return torch.cat(_exchange(axis, x), dim=dim)


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over the group, in axis order on every shard (so every shard
    holds the same bits); over a tuple of axes one axis after another."""
    for a in ((axis,) if isinstance(axis, str) else tuple(axis)):
        got = _exchange(a, x)
        x = got[0]
        for t in got[1:]:
            x = x + t
    return x


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """:func:`psum` divided by the group's size."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = 1
    for a in axes:
        n *= axis_size(a)
    return psum(x, axes) / n


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    got = _exchange(axis, x)
    out = got[0]
    for t in got[1:]:
        out = torch.maximum(out, t)
    return out


# ---------------------------------------------------------------------------
# Trees of tensors and their specs
# ---------------------------------------------------------------------------


def _whole(spec) -> bool:
    """Does ``spec`` cover a whole subtree (a :class:`P`, a callable or
    None) rather than mirror its structure?"""
    return spec is None or isinstance(spec, P) or (
        callable(spec) and not dataclasses.is_dataclass(spec))


def _sub(spec, key):
    if _whole(spec):
        return spec
    return getattr(spec, key) if isinstance(key, str) and \
        dataclasses.is_dataclass(spec) else spec[key]


def _map(fn, tree, spec):
    """Apply ``fn(leaf, spec)`` over a tree (tuples, lists, dicts and
    dataclasses of tensors, None and Python scalars) and its spec tree;
    a spec that is a :class:`P`, a callable or None covers the whole
    subtree below it."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t, _sub(spec, i))
                          for i, t in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v, _sub(spec, k)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), _sub(spec, f.name))
            for f in dataclasses.fields(tree)})
    return fn(tree, spec)


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    _map(lambda t, s: out.append(t) if isinstance(t, torch.Tensor) else None,
         tree, None)
    return out


def _spec_of(spec, leaf: torch.Tensor) -> P:
    if callable(spec) and not isinstance(spec, P):
        spec = spec(leaf)
    if spec is None:
        return P()
    return spec


def _slices(mesh, spec: P, shape, coords) -> Tuple[slice, ...]:
    """The slice of a global ``shape`` that ``coords`` holds under
    ``spec``."""
    out = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split "
                             f"{n} ways over {axes}")
        c = size // n
        out.append(slice(idx * c, (idx + 1) * c))
    return tuple(out)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

_STREAMS: Dict[Tuple[torch.device, int], "torch.cuda.Stream"] = {}
_STREAMS_LOCK = threading.Lock()


def _stream(device: torch.device, index: int):
    """A persistent CUDA stream for shard ``index`` on ``device``."""
    key = (device, index)
    with _STREAMS_LOCK:
        s = _STREAMS.get(key)
        if s is None:
            s = _STREAMS[key] = torch.cuda.Stream(device=device)
        return s


def shard_map(fn: Callable, mesh, in_specs: Sequence, out_specs
              ) -> Callable:
    """``jax.experimental.shard_map.shard_map`` for one controller: the
    returned function splits its arguments by ``in_specs`` (a spec tree
    per argument), runs ``fn`` on each mesh coordinate's pieces and
    gathers its outputs by ``out_specs`` (a spec tree; a callable leaf
    gives the spec of each output leaf from that leaf) onto the first
    device of the mesh.  Tensor arguments must lie on the mesh's device
    type: a CUDA mesh never runs a shard on the CPU."""

    def run(*args):
        return _run(fn, mesh, in_specs, out_specs, args)

    return run


def _run(fn, mesh, in_specs, out_specs, args):
    kind = mesh.devices[0].type
    for t in _leaves(args):
        if t.device.type != kind:
            raise ValueError(f"shard_map over a {kind} mesh got an operand "
                             f"on {t.device}")
    main = mesh.devices[0]
    cuda = kind == "cuda"
    coords = mesh.coords()
    run = _Run(mesh)

    # The pieces of every argument, each a dense tensor of its own (as a
    # shard's array is in JAX; the kernels take contiguous operands) on
    # its shard's device, made in this thread: the copies run on the
    # caller's streams, after its work.
    def split(c):
        dev = mesh.device_at(c)
        return _map(lambda t, s: t if not isinstance(t, torch.Tensor) else
                    t[_slices(mesh, _spec_of(s, t), t.shape, c)].to(dev)
                    .contiguous(), tuple(args), tuple(in_specs))


    pieces = [split(c) for c in coords]
    ready = {}
    if cuda:
        for dev in {mesh.device_at(c) for c in coords} | {main}:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ready[dev] = ev
    outs: List[Any] = [None] * len(coords)
    errors: List[Optional[BaseException]] = [None] * len(coords)
    done: List[Any] = [None] * len(coords)

    def body(i):
        c = coords[i]
        dev = mesh.device_at(c)
        stream = _stream(dev, i) if cuda else None
        _CTX.shard = _Shard(c, dev, stream, run)
        try:
            if cuda:
                torch.cuda.set_device(dev)
                stream.wait_event(ready[dev])
                stream.wait_event(ready[main])
                with torch.cuda.stream(stream):
                    outs[i] = fn(*pieces[i])
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    done[i] = ev
            else:
                outs[i] = fn(*pieces[i])
        except BaseException as e:  # noqa: BLE001 — handed to the caller
            errors[i] = e
            run.abort()
        finally:
            _CTX.shard = None

    threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                name=f"shard{i}") for i in range(len(coords))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)), None)
    if first is None:
        first = next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    if cuda:
        for i, c in enumerate(coords):
            for dev in {mesh.device_at(c), main}:
                torch.cuda.current_stream(dev).wait_event(done[i])
    return _gather(mesh, coords, outs, out_specs, main)


def _gather(mesh, coords, outs, out_specs, main):
    """The global outputs on ``main``: each coordinate's piece copied into
    its slice (replicated dims and axes: every holder writes the same
    piece)."""

    def gather(spec, pieces):
        first = pieces[0]
        if isinstance(first, (tuple, list)):
            return type(first)(gather(_sub(spec, j), [p[j] for p in pieces])
                               for j in range(len(first)))
        if isinstance(first, dict):
            return {k: gather(_sub(spec, k), [p[k] for p in pieces])
                    for k in first}
        if dataclasses.is_dataclass(first):
            return dataclasses.replace(first, **{
                f.name: gather(_sub(spec, f.name),
                               [getattr(p, f.name) for p in pieces])
                for f in dataclasses.fields(first)})
        if not isinstance(first, torch.Tensor):
            return first
        spec = _spec_of(spec, first)
        shape = list(first.shape)
        for dim in range(len(shape)):
            entry = spec[dim] if dim < len(spec) else None
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else tuple(entry)
                for a in axes:
                    shape[dim] *= mesh.shape[a]
        out = torch.empty(shape, dtype=first.dtype, device=main)
        for c, piece in zip(coords, pieces):
            if piece.is_cuda:
                # The shard's block may go back to its stream's pool once
                # this copy is queued: keep it until the copy has run.
                piece.record_stream(torch.cuda.current_stream(piece.device))
            out[_slices(mesh, spec, shape, c)].copy_(piece)
        return out

    return gather(out_specs, outs)

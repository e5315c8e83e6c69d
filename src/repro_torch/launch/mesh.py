"""The dispatch mesh of the port (the JAX package's ``launch/mesh.py``).

A :class:`Mesh` names its axes (``data``, ``model`` and, for
context-parallel ring attention, ``seq``), their sizes, and the device
of each mesh coordinate in row-major order.  It is what
``core.dispatch.set_dispatch_mesh`` installs and what
``distributed.spmd.shard_map`` runs a shard of the attention pipeline
on, one thread a coordinate (DESIGN.md §10, §14).

The visible devices are the CUDA cards, or the CPU when the caller asks
for it.  ``REPRO_TORCH_FORCE_DEVICE_COUNT=N`` (the counterpart of XLA's
``--xla_force_host_platform_device_count``, read only here) makes N
devices visible that are all the first one: N shards then share one
card, or the CPU, which is how the tests and the one-card smoke build a
mesh.

Several processes (the reference's multi-host ``jax.distributed``):
:func:`init_distributed` joins the process group over
``torch.distributed`` (NCCL on cards, gloo on the CPU) and
:func:`make_rank_mesh` lays the ranks out as a :class:`RankMesh` with the
reference's axis names, which the rule tables of
``distributed.sharding`` and the trainer's parameter shards
(``distributed.fsdp``) read.

Once the group exists, :func:`visible_devices` lists every rank's
devices rank-major (each rank's own: its bound card, or the CPU, or N
copies of it under the variable), learnt once a call by an all-gather.
A ``--mesh`` that fits one rank's own devices stays within the process,
as without a group; a larger one spans the ranks, each holding the same
number of coordinates, rank-major (:attr:`Mesh.ranks`), with a process
group for every axis group whose members lie on several ranks, made
when the mesh is built (``distributed.spmd`` exchanges over them).
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.utils.device import resolve_device

__all__ = ["FORCE_DEVICE_COUNT_ENV", "Mesh", "RankMesh", "axis_group",
           "axis_groups", "group_timeout_s", "init_distributed",
           "launched_by_torchrun",
           "make_host_mesh", "make_rank_mesh", "own_devices",
           "parse_mesh_spec", "process_device", "visible_devices"]

FORCE_DEVICE_COUNT_ENV = "REPRO_TORCH_FORCE_DEVICE_COUNT"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes and the row-major devices of a mesh; over
    several processes also the rank that holds each coordinate, this
    process's rank, and the process groups of the axis groups that span
    ranks (keyed as :func:`axis_group` keys them, with ``("*",)`` the
    group of every rank of the mesh)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    ranks: Tuple[int, ...] = ()
    rank: int = 0
    groups: Dict[Tuple, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"mesh {self.axis_sizes} needs "
                             f"{math.prod(self.axis_sizes)} devices, got "
                             f"{len(self.devices)}")
        if self.ranks and len(self.ranks) != len(self.devices):
            raise ValueError("one rank per mesh coordinate")

    @property
    def spans_ranks(self) -> bool:
        return len(set(self.ranks)) > 1

    def flat_index(self, coords: Dict[str, int]) -> int:
        """The row-major position of ``coords``."""
        flat = 0
        for name, n in zip(self.axis_names, self.axis_sizes):
            flat = flat * n + coords[name]
        return flat

    def rank_at(self, coords: Dict[str, int]) -> int:
        if not self.ranks:
            return self.rank
        return self.ranks[self.flat_index(coords)]

    def local_coords(self) -> List[Dict[str, int]]:
        """The coordinates this process holds, in row-major order."""
        return [c for c in self.coords() if self.rank_at(c) == self.rank]

    @property
    def main_device(self) -> torch.device:
        """This process's first device of the mesh: where shard_map
        gathers the outputs."""
        return self.device_at(self.local_coords()[0])

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self) -> List[Dict[str, int]]:
        """Every mesh coordinate, in the devices' row-major order."""
        out = [{}]
        for name, n in zip(self.axis_names, self.axis_sizes):
            out = [{**c, name: i} for c in out for i in range(n)]
        return out

    def device_at(self, coords: Dict[str, int]) -> torch.device:
        return self.devices[self.flat_index(coords)]

    def layout(self) -> Dict[int, List[Dict[str, int]]]:
        """rank -> the coordinates it holds."""
        out: Dict[int, List[Dict[str, int]]] = {}
        for c in self.coords():
            out.setdefault(self.rank_at(c), []).append(c)
        return out

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices})
        ranks = f", ranks={len(set(self.ranks))}" if self.spans_ranks else ""
        return f"Mesh({self.shape}, devices={devs}{ranks})"


def axis_group(coords: Dict[str, int], axis: str) -> Tuple:
    """The key of the group of coordinates that differ from ``coords``
    on ``axis`` only (the members of a collective over ``axis``)."""
    return (axis,) + tuple(sorted((a, i) for a, i in coords.items()
                                  if a != axis))


def _grouped() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def visible_devices(device: Optional[Union[str, torch.device]] = None
                    ) -> List[torch.device]:
    """The devices a mesh may use: every CUDA card (the default), or the
    CPU when ``device`` is a CPU device; with
    ``REPRO_TORCH_FORCE_DEVICE_COUNT=N`` N copies of the first one.  Once
    a process group exists, every rank's own devices
    (:func:`own_devices`), rank-major: a collective, which every rank
    calls."""
    if _grouped():
        return [d for devs in _rank_devices(device) for d in devs]
    return own_devices(device)


def own_devices(device: Optional[Union[str, torch.device]] = None
                ) -> List[torch.device]:
    """This process's devices: without a process group every CUDA card
    (or the CPU), with one the card the process is bound to
    (:func:`process_device`); with the variable N copies of the first."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = ([process_device(dev)] if _grouped() else
                [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())])
    else:
        devs = [torch.device(dev.type)]
    forced = os.environ.get(FORCE_DEVICE_COUNT_ENV, "").strip()
    if forced:
        n = int(forced)
        if n < 1:
            raise ValueError(f"{FORCE_DEVICE_COUNT_ENV}={forced!r}: must "
                             f"be >= 1")
        devs = [devs[0]] * n
    return devs


def _rank_devices(device) -> List[List[torch.device]]:
    """Every rank's own devices, by rank: one all-gather over the group."""
    import torch.distributed as dist

    got: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(got, [str(d) for d in own_devices(device)])
    return [[torch.device(d) for d in devs] for devs in got]


def _mesh(shape: Sequence[int], names: Sequence[str],
          devs: Sequence[torch.device]) -> Mesh:
    n = math.prod(shape)
    return Mesh(tuple(names), tuple(int(s) for s in shape), tuple(devs[:n]))


def _rank_mesh(shape: Sequence[int], names: Sequence[str],
               per_rank: Sequence[Sequence[torch.device]],
               spec: str) -> Mesh:
    """A dispatch mesh over every rank: ``n / world`` coordinates each,
    rank-major, with a process group for each axis group that spans
    ranks, made here in one order on every rank (``new_group`` is
    collective over the whole world)."""
    import torch.distributed as dist

    n, world = math.prod(shape), len(per_rank)
    counts = [len(d) for d in per_rank]
    if n > sum(counts):
        raise ValueError(
            f"mesh {spec} needs {n} devices but only {sum(counts)} are "
            f"visible over {world} ranks ({counts} a rank); set "
            f"{FORCE_DEVICE_COUNT_ENV} on every rank to place more shards "
            f"on each rank's device")
    k = n // world
    if n % world or k > min(counts):
        raise ValueError(
            f"mesh {spec} ({n} coordinates) does not split evenly over "
            f"{world} ranks holding {counts} devices: every rank must hold "
            f"the same number of coordinates")
    devs = tuple(d for r in range(world) for d in per_rank[r][:k])
    ranks = tuple(r for r in range(world) for _ in range(k))
    mesh = Mesh(tuple(names), tuple(int(s) for s in shape), devs, ranks,
                dist.get_rank())
    timeout = (None if group_timeout_s() is None
               else timedelta(seconds=group_timeout_s()))
    members: Dict[Tuple, List[int]] = {}
    for axis in mesh.axis_names:
        for c in mesh.coords():
            members.setdefault(axis_group(c, axis), []).append(
                mesh.rank_at(c))
    members[("*",)] = list(range(world))
    for key, rs in members.items():
        if len(set(rs)) > 1:
            mesh.groups[key] = dist.new_group(sorted(set(rs)),
                                              timeout=timeout)
    return mesh


def make_host_mesh(model_axis: int = 1, device=None) -> Mesh:
    """Small (data, model) mesh over this process's devices."""
    devs = own_devices(device)
    n = len(devs)
    model_axis = min(model_axis, n)
    return _mesh((n // model_axis, model_axis), ("data", "model"), devs)


def parse_mesh_spec(spec: str, device=None) -> Mesh:
    """``--mesh DxM`` / ``--mesh DxMxS`` -> a dispatch mesh.

    '8' means (data=8, model=1); '4x2' means (data=4, model=2); a third
    component adds the context-parallel ``seq`` axis (DESIGN.md §14):
    '1x1x2' shards the token axis 2-way for ring attention.  The mesh
    takes the process's first D·M·S devices (:func:`own_devices`) and
    raises when there are fewer; once a process group exists, a mesh
    larger than them spans the ranks (:func:`_rank_mesh`: D·M·S / world
    coordinates a rank) and raises when all ranks' devices are too few
    or do not split it evenly."""
    parts = spec.lower().replace("×", "x").split("x")
    if not 1 <= len(parts) <= 3:
        raise ValueError(f"mesh spec {spec!r}: expected 'D', 'DxM' or "
                         f"'DxMxS'")
    dims = [int(p) for p in parts] + [1] * (3 - len(parts))
    d, m, s = dims
    if d < 1 or m < 1 or s < 1:
        raise ValueError(f"mesh spec {spec!r}: axes must be >= 1")
    shape, names = ((d, m, s), ("data", "model", "seq")) \
        if len(parts) == 3 else ((d, m), ("data", "model"))
    devs = own_devices(device)
    avail = len(devs)
    if d * m * s > avail and _grouped():
        return _rank_mesh(shape, names, _rank_devices(device),
                          f"{d}x{m}x{s}")
    if d * m * s > avail:
        raise ValueError(
            f"mesh {d}x{m}x{s} needs {d * m * s} devices but only {avail} "
            f"are visible; set {FORCE_DEVICE_COUNT_ENV}={d * m * s} to "
            f"place {d * m * s} shards on the first device")
    return _mesh(shape, names, devs)


# --- several processes ---------------------------------------------------------

# The group's timeout as init_distributed set it, for the subgroups a
# dispatch mesh makes (new_group's own default is the backend's, 30 min
# for gloo); None when the group was made elsewhere.
_GROUP_TIMEOUT_S: Optional[float] = None


def group_timeout_s() -> Optional[float]:
    """The timeout :func:`init_distributed` gave the group (None when the
    group was made elsewhere), for the groups made after it."""
    return _GROUP_TIMEOUT_S


def launched_by_torchrun() -> bool:
    """Was this process started by ``torchrun`` (``torch.distributed.run``),
    which sets the ``env://`` rendezvous variables?"""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device=None,
                     timeout_s: float = 600.0) -> bool:
    """Join the ``torch.distributed`` process group once, before the run
    touches a device: the reference's ``init_distributed`` over
    ``jax.distributed`` (DESIGN.md §15.4).

    With no arguments the rendezvous is ``env://``: torchrun's
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``.  A
    ``HOST:PORT`` coordinator becomes ``tcp://HOST:PORT``, with
    ``num_processes`` and ``process_id`` (else ``WORLD_SIZE`` and
    ``RANK`` from the environment).  The backend is NCCL when ``device``
    is CUDA (the default) and gloo on the CPU; on CUDA each process binds
    ``cuda:LOCAL_RANK`` (else its process id modulo the visible cards).
    Returns True after a real init and False when the group already
    exists (a router restart must not init again).  An unreachable
    coordinator raises after ``timeout_s``; it never carries on as a
    single process."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if k not in env]
        if missing:
            raise RuntimeError(f"init_distributed: no coordinator given and "
                               f"{missing} unset (start under torchrun or "
                               f"pass --coordinator HOST:PORT)")
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed: a coordinator needs "
                             "num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    global _GROUP_TIMEOUT_S
    _GROUP_TIMEOUT_S = timeout_s
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))
    return True


def process_device(device=None) -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK``'s card bound by
    :func:`init_distributed` (``torch.cuda.current_device``), or the
    CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """The ranks of the process group as a mesh with the reference's axis
    names: what the rule tables read (``axis_names``, ``shape``), this
    rank's coordinate (``device_mesh.get_coordinate()``, row-major over
    the ranks), and the process groups the trainer runs its
    collectives over: the batch group (the ranks that share this rank's
    ``model`` index, over ``pod`` and ``data``), along which FSDP gathers
    and reduces, and the model group (the ranks that share its batch
    index), along which tensor parallelism combines its pieces
    (``distributed.tensor_parallel``).  ``groups`` holds this rank's two
    (``"batch"``, ``"model"``; None where the axis has one rank), made by
    :func:`make_rank_mesh` in one order on every rank."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device
    device_mesh: Any = dataclasses.field(compare=False, repr=False)
    groups: Dict[str, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    def coordinate(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def batch_group(self):
        """The process group over the batch axes (``pod`` and ``data``)
        that holds this rank: every rank while the ``model`` axis is 1;
        None when the batch axes have one rank."""
        import torch.distributed as dist

        if "batch" in self.groups:
            return self.groups["batch"]
        return dist.group.WORLD if self.model_size == 1 else None

    def model_group(self):
        """The process group over the ``model`` axis that holds this rank
        (None while the axis is 1)."""
        return self.groups.get("model")

    def batch_index(self) -> int:
        """This rank's index along the batch axes, row-major."""
        c, idx = self.coordinate(), 0
        for a in ("pod", "data"):
            if a in c:
                idx = idx * self.shape[a] + c[a]
        return idx

    def model_index(self) -> int:
        """This rank's index along the ``model`` axis."""
        return self.coordinate().get("model", 0)

    def tensor_parallel(self, seq_parallel: bool = False):
        """The tensor parallelism of this rank over the ``model`` axis (a
        ``distributed.tensor_parallel.TensorParallel``), None while the
        axis is 1."""
        from repro_torch.distributed.tensor_parallel import TensorParallel

        if self.model_size == 1:
            return None
        return TensorParallel(self.model_group(), self.model_size,
                              self.model_index(), seq_parallel)

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, device={self.device})"


class _RowMajor:
    """A rank's coordinate on a row-major mesh of ``shape`` (what
    :class:`RankMesh` reads of its ``device_mesh``)."""

    def __init__(self, shape: Sequence[int], rank: int):
        self.coordinate = []
        for n in reversed(shape):
            self.coordinate.insert(0, rank % n)
            rank //= n

    def get_coordinate(self) -> List[int]:
        return list(self.coordinate)


def axis_groups(shape: Sequence[int], rank: int, new_group) -> Dict[str, Any]:
    """This rank's batch and model groups on a row-major mesh of
    ``shape`` whose last axis is ``model``: ``new_group(ranks)`` is called
    for every group of every axis in one order (on a real process group
    each call is collective over the whole world), and the two that hold
    ``rank`` are kept.  A model axis of 1 makes none (the batch group is
    the world); an axis of one rank has no group."""
    m = shape[-1]
    world = math.prod(shape)
    if m == 1:
        return {}
    out: Dict[str, Any] = {}
    n_batch = world // m
    for b in range(n_batch):           # the model groups, batch-major
        ranks = list(range(b * m, (b + 1) * m))
        g = new_group(ranks) if n_batch > 1 else None
        if rank in ranks:
            out["model"] = g
    if n_batch == 1:
        import torch.distributed as dist

        out["model"] = dist.group.WORLD
        return out
    for j in range(m):                 # the batch groups, one a model index
        ranks = list(range(j, world, m))
        g = new_group(ranks)
        if rank in ranks:
            out["batch"] = g
    return out


def make_rank_mesh(model_axis: int = 1, pods: int = 1, device=None) -> RankMesh:
    """The process group's ranks as a (data, model) mesh, or (pod, data,
    model) with ``pods`` > 1: the counterpart of the reference's
    ``make_host_mesh()`` over ``jax.devices()`` once they span processes,
    row-major (a rank's model neighbours are consecutive ranks).  A
    ``model_axis`` above 1 makes the batch and model groups
    (:func:`axis_groups`).  Needs :func:`init_distributed` first."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_rank_mesh needs init_distributed() first")
    n = dist.get_world_size()
    if n % (model_axis * pods):
        raise ValueError(f"{n} ranks do not split into {pods} pods x "
                         f"model {model_axis}")
    shape = (n // (model_axis * pods), model_axis)
    names = ("data", "model")
    if pods > 1:
        shape, names = (pods,) + shape, ("pod",) + names
    dev = process_device(device)
    dm = _RowMajor(shape, dist.get_rank())
    timeout = (None if group_timeout_s() is None
               else timedelta(seconds=group_timeout_s()))
    groups = axis_groups(shape, dist.get_rank(),
                         lambda ranks: dist.new_group(ranks, timeout=timeout))
    return RankMesh(names, shape, dev, dm, groups)

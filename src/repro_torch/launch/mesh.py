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
mesh.  Multi-host initialisation (the reference's ``init_distributed``)
is not ported.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.utils.device import resolve_device

__all__ = ["FORCE_DEVICE_COUNT_ENV", "Mesh", "make_host_mesh",
           "parse_mesh_spec", "visible_devices"]

FORCE_DEVICE_COUNT_ENV = "REPRO_TORCH_FORCE_DEVICE_COUNT"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes and the row-major devices of a mesh."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"mesh {self.axis_sizes} needs "
                             f"{math.prod(self.axis_sizes)} devices, got "
                             f"{len(self.devices)}")

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
        flat = 0
        for name, n in zip(self.axis_names, self.axis_sizes):
            flat = flat * n + coords[name]
        return self.devices[flat]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices})
        return f"Mesh({self.shape}, devices={devs})"


def visible_devices(device: Optional[Union[str, torch.device]] = None
                    ) -> List[torch.device]:
    """The devices a mesh may use: every CUDA card (the default), or the
    CPU when ``device`` is a CPU device; with
    ``REPRO_TORCH_FORCE_DEVICE_COUNT=N`` N copies of the first one."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
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


def _mesh(shape: Sequence[int], names: Sequence[str],
          devs: Sequence[torch.device]) -> Mesh:
    n = math.prod(shape)
    return Mesh(tuple(names), tuple(int(s) for s in shape), tuple(devs[:n]))


def make_host_mesh(model_axis: int = 1, device=None) -> Mesh:
    """Small (data, model) mesh over whatever devices are visible."""
    devs = visible_devices(device)
    n = len(devs)
    model_axis = min(model_axis, n)
    return _mesh((n // model_axis, model_axis), ("data", "model"), devs)


def parse_mesh_spec(spec: str, device=None) -> Mesh:
    """``--mesh DxM`` / ``--mesh DxMxS`` -> a dispatch mesh.

    '8' means (data=8, model=1); '4x2' means (data=4, model=2); a third
    component adds the context-parallel ``seq`` axis (DESIGN.md §14):
    '1x1x2' shards the token axis 2-way for ring attention.  The mesh
    takes the first D·M·S visible devices (:func:`visible_devices`) and
    raises when there are fewer."""
    parts = spec.lower().replace("×", "x").split("x")
    if not 1 <= len(parts) <= 3:
        raise ValueError(f"mesh spec {spec!r}: expected 'D', 'DxM' or "
                         f"'DxMxS'")
    dims = [int(p) for p in parts] + [1] * (3 - len(parts))
    d, m, s = dims
    if d < 1 or m < 1 or s < 1:
        raise ValueError(f"mesh spec {spec!r}: axes must be >= 1")
    devs = visible_devices(device)
    avail = len(devs)
    if d * m * s > avail:
        raise ValueError(
            f"mesh {d}x{m}x{s} needs {d * m * s} devices but only {avail} "
            f"are visible; set {FORCE_DEVICE_COUNT_ENV}={d * m * s} to "
            f"place {d * m * s} shards on the first device")
    if len(parts) == 3:
        return _mesh((d, m, s), ("data", "model", "seq"), devs)
    return _mesh((d, m), ("data", "model"), devs)

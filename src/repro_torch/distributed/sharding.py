"""What the dispatcher and the launcher read of a mesh's axes (the JAX
package's ``distributed/sharding.py``, its first two helpers).  The
logical-axis rule tables and ``ShardCtx`` are GSPMD constraints for
training and are not ported."""

from __future__ import annotations

import math
from typing import Optional, Tuple

__all__ = ["axis_size", "batch_axes"]


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes that shard a batch: ``pod`` and ``data``, where the
    mesh has them."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, axes: Optional[object]) -> int:
    """The number of shards over ``axes`` (a name, a tuple of names, or
    None for 1)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(int(mesh.shape[a]) for a in axes)

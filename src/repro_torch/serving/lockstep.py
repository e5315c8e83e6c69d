"""Serving in lockstep over the ranks of a dispatch mesh that spans
processes.

Under such a mesh every rank runs the same model on the same batches,
and each sharded attention call is a set of collectives that every rank
must enter in the same order: a rank that batched differently would hang
its peers until the group's timeout.  So rank 0 (the leader) makes every
decision the engine would take from its own clocks and threads, and the
other ranks follow it (``serving.engine.DiffusionEngine(lockstep=...)``):

* the drain order and the batch: the leader's bucket key and request
  ids, broadcast before the batch runs; a follower serves those ids from
  its own queue, whatever order they were submitted in;
* admission control: only the leader sheds, and its sheds ride the next
  broadcast;
* each attempt's policy on the guardrail ladder and the watchdog's
  budget, broadcast before the attempt runs;
* each attempt's verdict: every rank's outcome (hung, failed, sentinel
  trip or clean) all-gathered, and the worst, the lowest rank's among
  equals, taken by all.

Every batch is checked: each rank's digest of it (the key and each
request's id, seed, shape, steps, policy and text) is all-gathered and a
mismatch raises :class:`LockstepError` on every rank.  The messages go
over a gloo group of their own (CPU objects, whatever the mesh's
backend), made by every rank in the same order, after the mesh's
groups.
"""

from __future__ import annotations

import hashlib
from datetime import timedelta
from typing import Any, List, Optional

import numpy as np

__all__ = ["Lockstep", "LockstepError", "batch_digest"]


class LockstepError(RuntimeError):
    """The ranks disagree on what they serve."""


class Lockstep:
    """The control channel of one engine over every rank of the group."""

    def __init__(self, timeout_s: Optional[float] = None):
        import torch.distributed as dist

        timeout = None if timeout_s is None else timedelta(seconds=timeout_s)
        self.group = dist.new_group(backend="gloo", timeout=timeout)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def share(self, obj: Any = None) -> Any:
        """The leader's ``obj`` on every rank (the others pass nothing)."""
        import torch.distributed as dist

        box = [obj if self.leader else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, by rank."""
        import torch.distributed as dist

        got: List[Any] = [None] * self.world
        dist.all_gather_object(got, obj, group=self.group)
        return got

    def check(self, what: str, digest: str) -> None:
        """Raise on every rank unless every rank's ``digest`` is the
        same."""
        got = self.gather(digest)
        if any(g != got[0] for g in got):
            raise LockstepError(f"{what}: the ranks disagree (" + "; ".join(
                f"rank {r}: {g}" for r, g in enumerate(got)) + ")")


def batch_digest(key, requests) -> str:
    """A short digest of one batch: its bucket key and each request's id,
    seed, latent shape, steps, policy, cadences and text embedding."""
    h = hashlib.sha256(repr(key).encode())
    for r in requests:
        h.update(repr((r.request_id, r.seed, tuple(r.latent_shape), r.steps,
                       r.policy, r.reuse_every, r.stream_every)).encode())
        h.update(np.ascontiguousarray(r.txt, np.float32).tobytes())
    return h.hexdigest()[:16]

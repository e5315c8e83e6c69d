"""Elastic scaling: re-shard a training state onto a mesh of another
size (the JAX package's ``distributed/elastic.py``).

Checkpoints store whole (gathered) arrays keyed by tree path, so a job
restarted on another topology takes each leaf's piece by the same
logical-axis rules against the *new* mesh: logical axes do not depend on
the mesh, which is the point of the indirection.  The trainer restores
this way at any number of ranks (``distributed.fsdp``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.distributed.sharding import param_rules, spec_from_axes
from repro_torch.distributed.spmd import P, _slices

__all__ = ["local_piece", "reshard_state"]


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _map(fn, state, axes):
    if _is_axes(axes):
        return fn(state, axes)
    if isinstance(state, dict):
        return {k: _map(fn, v, axes[k]) for k, v in state.items()}
    return [_map(fn, v, a) for v, a in zip(state, axes)]


def local_piece(t: torch.Tensor, spec: P, mesh, coords: Dict[str, int]
                ) -> torch.Tensor:
    """The piece of the whole tensor ``t`` that mesh coordinate ``coords``
    holds under ``spec`` (a view)."""
    return t[_slices(mesh, spec, tuple(t.shape), coords)]


def reshard_state(state, logical_tree, mesh, rules: Optional[Dict] = None,
                  coords: Optional[Dict[str, int]] = None):
    """The piece of every leaf of ``state`` (nested dicts and lists of
    whole tensors) that mesh coordinate ``coords`` holds under its
    rule-table spec (``logical_tree``: the same structure with axis
    tuples; default rules ``param_rules(mesh)``, default coordinate this
    rank's on a :class:`~repro_torch.launch.mesh.RankMesh`).  Dims the
    mesh does not divide stay whole.  Each piece is a tensor of its
    own."""
    rules = rules or param_rules(mesh)
    if coords is None:
        coords = mesh.coordinate()
    return _map(lambda t, ax: local_piece(
        t, spec_from_axes(ax, rules, tuple(t.shape), mesh), mesh, coords).clone(),
        state, logical_tree)

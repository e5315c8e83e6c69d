"""Helpers over the port's parameter containers: a tensor, or nested
dicts, lists and tuples (NamedTuples included) of tensors; ``None``
holds no leaf.  A model's parameters enter as ``list(model.parameters())``
or as its ``jax_tree`` (``models.params``).  The counterpart of the JAX
package's ``utils/pytree.py``."""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_items(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of every leaf in order: a dict's keys sorted (as
    ``jax.tree_util`` orders them), a NamedTuple's fields by name, a
    list's or tuple's items by index."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from tree_items(getattr(tree, k), prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_global_norm(tree) -> torch.Tensor:
    """Global L2 norm over all leaves, in float32 (used for gradient
    clipping): the norm of the per-leaf norms."""
    leaves = [x.float() for x in tree_leaves(tree)]
    if not leaves:
        return torch.zeros(())
    norms = torch._foreach_norm(leaves)
    return torch.linalg.vector_norm(torch.stack(norms))

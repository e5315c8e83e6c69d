"""Logical-axis sharding: where logical names meet the mesh (the JAX
package's ``distributed/sharding.py``).

Parameters carry logical axes (``models.params``: ``embed``, ``heads``,
``kv``, ``mlp``, ``vocab``, ``expert``, None) and a workload picks a
rule table that maps each logical name to mesh axes.  The rule tables
read only a mesh's ``axis_names`` and its ``shape`` (axis -> size), so
they take the port's dispatch :class:`~repro_torch.launch.mesh.Mesh` and
its rank mesh (:class:`~repro_torch.launch.mesh.RankMesh`) alike; a spec
is a :class:`~repro_torch.distributed.spmd.P`.

The production mesh comes in two shapes, single-pod ``(data, model)``
and multi-pod ``(pod, data, model)``; the batch axis absorbs ``pod``
only where it exists.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.distributed.spmd import P

__all__ = ["NULL_CTX", "ShardCtx", "attn_seq_fallback", "axis_size",
           "batch_axes", "decode_act_rules", "param_rules",
           "param_sharding_tree", "seqpar_act_rules", "spec_from_axes",
           "train_act_rules"]


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


# --- parameter rules ---------------------------------------------------------

def param_rules(mesh, fsdp: bool = True) -> Dict[Any, Any]:
    """Logical param axis -> mesh axes.  FSDP shards the ``embed`` dim of
    weights over the batch axes (ZeRO-3 style); tensor dims over
    ``model``."""
    bd = batch_axes(mesh)
    return {
        "embed": bd if fsdp else None,
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "layers": None,
        None: None,
    }


def spec_from_axes(axes: Sequence[Optional[str]], rules: Dict[Any, Any],
                   shape: Optional[Tuple[int, ...]] = None,
                   mesh=None) -> P:
    """Map a logical-axis tuple to a partition spec, dropping assignments
    that do not divide the dimension (e.g. kv heads 8 on a model axis of
    16 fall back to replicated) and any mesh axis already used by an
    earlier dim; trailing replicated dims are dropped."""
    entries = []
    used = set()
    for i, a in enumerate(axes):
        target = rules.get(a, None)
        if target is not None and mesh is not None and shape is not None:
            if shape[i] % axis_size(mesh, target) != 0:
                target = None
        flat = (target,) if isinstance(target, str) else tuple(target or ())
        if any(t in used for t in flat):
            target = None
        else:
            used.update(flat)
        entries.append(target)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def param_sharding_tree(logical_tree, mesh, rules: Dict[Any, Any],
                        shapes=None):
    """The spec of every leaf of a logical-axes tree (nested dicts and
    lists whose leaves are axis tuples); with ``shapes`` (the same tree
    with shape tuples) dims that the mesh does not divide replicate."""
    def is_axes(x):
        return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                            for a in x)

    def walk(axes, shp):
        if is_axes(axes):
            return spec_from_axes(axes, rules, shp, mesh if shp else None)
        if isinstance(axes, dict):
            return {k: walk(v, None if shp is None else shp[k])
                    for k, v in axes.items()}
        return [walk(v, None if shp is None else shp[i])
                for i, v in enumerate(axes)]

    return walk(logical_tree, shapes)


# --- activation rules / ShardCtx ---------------------------------------------


def train_act_rules(mesh, seq_parallel: bool = False) -> Dict[Any, Any]:
    bd = batch_axes(mesh)
    return {
        "batch": bd, "seq": "model" if seq_parallel else None,
        "embed": None,
        "heads": "model", "kv": None, "mlp": "model", "vocab": "model",
        "expert": "model", "kv_seq": None, None: None,
        # attention operands always need the full sequence per head:
        "attn_seq": None,
    }


def attn_seq_fallback(arch, mesh, rules: Dict[Any, Any]) -> Dict[Any, Any]:
    """The reference workloads' ``_attn_seq_fallback``: an arch whose head
    count the ``model`` axis does not divide (vdit-paper's and flux-dev's
    24 heads on 16) shards attention over the query rows instead
    (``attn_seq`` on ``model``: logits (B, H, Nq/M, Nk), K and V whole);
    ``rules`` unchanged otherwise."""
    heads = getattr(arch.model, "num_heads", 0)
    if mesh is not None and "model" in mesh.axis_names and heads and \
            heads % int(mesh.shape["model"]) != 0:
        rules = dict(rules)
        rules["attn_seq"] = "model"
    return rules


def decode_act_rules(mesh, long_context: bool = False,
                     replicate_heads: bool = False) -> Dict[Any, Any]:
    bd = batch_axes(mesh)
    rules = train_act_rules(mesh)
    # KV cache sequence shards over 'model' (flash-decode combine); for
    # 512k single-request decode it spreads over every axis.
    rules["kv_seq"] = (*bd, "model") if long_context else "model"
    if long_context:
        rules["batch"] = ()
    if replicate_heads:
        # decode attention FLOPs are tiny; replicating q-heads avoids the
        # heads<->kv_seq resharding ping-pong on the model axis.
        rules["heads"] = None
    return rules


def seqpar_act_rules(mesh, batch: int) -> Dict[Any, Any]:
    """Inference sequence-parallel rules for small-batch diffusion and
    vision: the batch takes the largest prefix of (pod, data) that
    divides it and the leftover axes go to the token dim."""
    bd = list(batch_axes(mesh))
    b_axes, s_axes = [], []
    remaining = batch
    for a in bd:
        n = mesh.shape[a] if mesh else 1
        if remaining % n == 0 and remaining >= n:
            b_axes.append(a)
            remaining //= n
        else:
            s_axes.append(a)
    rules = train_act_rules(mesh)
    rules["batch"] = tuple(b_axes)
    rules["seq"] = tuple(s_axes)
    # inference sequence parallelism shards attention rows too
    rules["attn_seq"] = tuple(s_axes)
    return rules


@dataclasses.dataclass
class ShardCtx:
    """Threaded through model code: the mesh and the activation rules a
    workload runs under.  ``mesh`` is what the MoE reads to choose expert
    parallelism on a dispatch mesh (``models.moe.moe_ffn``); ``tp`` is
    the trainer's tensor parallelism on a rank mesh.

    :meth:`c` returns ``x`` unchanged: the reference's
    ``with_sharding_constraint`` tells GSPMD where an activation should
    live and changes no value, and the port's tensors are whole on each
    process (a shard_map body gets its piece explicitly), so there is
    nothing to constrain."""

    mesh: Optional[Any] = None
    rules: Optional[Dict[Any, Any]] = None
    # The ranks that split a training batch (``distributed.fsdp``), over
    # which batch statistics such as the MoE router's are averaged.
    batch_group: Optional[Any] = None
    # This rank's tensor parallelism over the rank mesh's ``model`` axis
    # (a ``distributed.tensor_parallel.TensorParallel``; None at 1): the
    # LM's blocks, embedding, head and cross entropy then compute on the
    # rank's pieces and combine them over the model group.
    tp: Optional[Any] = None

    @property
    def attn_rows(self) -> bool:
        """Whether attention splits its query rows over ``model`` (the
        rules' ``attn_seq``, :func:`attn_seq_fallback`) rather than its
        heads."""
        return (self.rules or {}).get("attn_seq") == "model"

    def c(self, x, axes: Sequence[Optional[str]]):
        """Constrain activation ``x`` whose dims carry logical ``axes``:
        the identity (see the class docstring)."""
        return x


NULL_CTX = ShardCtx()

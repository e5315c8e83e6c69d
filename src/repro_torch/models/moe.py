"""Mixture-of-Experts FFN (Qwen-MoE / Phi-3.5-MoE style), as the JAX
package's ``repro/models/moe.py``.

Routed experts with softmax top-k gating (weights renormalised over the
k chosen) plus optional always-on shared experts behind a sigmoid gate.
The ``dense`` path computes every expert on every token and combines
them with the gate weights: exact, no capacity drops.  The router's aux
loss is the Switch load-balance loss plus 1e-3 of the router z-loss,
times ``aux_loss_weight``.  Under autograd the top-k gate weights (the
sorted probabilities) carry gradient into the router, as ``lax.top_k``'s
do; the chosen indices carry none.

The ``ep`` path is expert parallelism over the ``model`` axis of a
dispatch mesh (``ShardCtx.mesh``), through the port's
``distributed.spmd.shard_map``.  Token activations are replicated over
``model`` (split over the batch axes where they divide), so each model
shard selects the tokens routed to its own slab of experts locally: no
all-to-all; the combine is a ``psum`` over ``model``.  Tokens beyond a
(shard, expert) capacity are dropped in the reference's slot order (the
cumulative count of slots routed to the expert, token-major), as
GShard/Switch do at scale.  ``auto`` takes it exactly where the
reference's does: a mesh with a ``model`` axis that divides the experts.
On a dispatch mesh EP serves only (its shards are threads of one
process).

The trainer's EP runs on a rank mesh with a ``model`` axis above 1
(``ShardCtx.tp``, ``distributed.tensor_parallel``), under autograd: the
router runs on the model group's replicated tokens (this rank's rows of
the batch), each rank's E/M experts (its model piece of the expert
weights) take their slots through ``_local_dispatch_ffn`` in the
reference's slot order and capacity, and the partial outputs are summed
over the group by the caller (``tp.leave``).  The aux loss is this
rank's tokens', as the reference's per-shard aux; the trainer averages
it over the batch axes with the gradients.  At a model axis of 1 the
trainer runs the dense path with the router's means over the ranks
(below), a deliberate difference from the reference's EP there.

Under data parallelism over several processes (the trainer's rank mesh)
``ShardCtx.batch_group`` names the ranks that split the batch: the
router's load-balance and z-loss statistics are then averaged over them
(a differentiable all-reduce), so the aux loss is the whole batch's, as
at one rank.
"""

from __future__ import annotations

import types
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import MoEConfig
from repro_torch.distributed.sharding import NULL_CTX, ShardCtx
from repro_torch.models.common import mlp, mlp_partial, param


class SharedExperts(nn.Module):
    """The shared experts' gated MLP (wi_gate, wi_up, wo) and their gate
    (d_model, 1)."""

    def __init__(self, d: int, f: int, device=None, dtype=None):
        super().__init__()
        self.wi_gate = param(d, f, device=device, dtype=dtype)
        self.wi_up = param(d, f, device=device, dtype=dtype)
        self.wo = param(f, d, device=device, dtype=dtype)
        self.gate = param(d, 1, device=device, dtype=dtype)


class MoE(nn.Module):
    """Leaves of the JAX ``moe_defs``: router (d, E), wi_gate and wi_up
    (E, d, F), wo (E, F, d), and ``shared`` with shared experts."""

    def __init__(self, d_model: int, cfg: MoEConfig, device=None, dtype=None):
        super().__init__()
        E, Fw = cfg.num_experts, cfg.expert_ffw_dim
        self.router = param(d_model, E, device=device, dtype=dtype)
        self.wi_gate = param(E, d_model, Fw, device=device, dtype=dtype)
        self.wi_up = param(E, d_model, Fw, device=device, dtype=dtype)
        self.wo = param(E, Fw, d_model, device=device, dtype=dtype)
        self.shared = (SharedExperts(d_model, Fw * cfg.num_shared_experts,
                                     device, dtype)
                       if cfg.num_shared_experts else None)


def _expert_ffn(w_gate, w_up, w_out, x):
    """x: (E, C, d) -> (E, C, d); expert-batched gated FFN."""
    h = F.silu(torch.matmul(x, w_gate)) * torch.matmul(x, w_up)
    return torch.matmul(h, w_out)


def _router(p: MoE, x: torch.Tensor, cfg: MoEConfig, group=None):
    """(topk_idx (N, k), topk_w (N, k) float32, aux scalar). x: (N, d).
    With ``group`` (the ranks that split the batch) the aux loss's token
    means are averaged over the ranks."""
    logits = torch.matmul(x, p.router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: equal values in index order (bf16 logits tie often).
    topk_w, topk_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_idx = topk_w[:, :cfg.top_k], topk_idx[:, :cfg.top_k]
    topk_w = topk_w / topk_w.sum(-1, keepdim=True)
    E = cfg.num_experts
    me = probs.mean(0)
    ce = F.one_hot(topk_idx, E).sum(1).float().mean(0) / cfg.top_k
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    if group is not None:
        me, ce, z = _batch_mean(group, me, ce, z)
    lb = E * torch.sum(me * ce)
    aux = cfg.aux_loss_weight * (lb + 1e-3 * z)
    return topk_idx, topk_w, aux


def _batch_mean(group, me, ce, z):
    """The token means over every rank's rows (equal row counts): one
    differentiable all-reduce of the three statistics."""
    import torch.distributed as dist
    from torch.distributed.nn import functional as dist_fn

    E = me.shape[0]
    total = dist_fn.all_reduce(torch.cat([me, ce, z[None]]),
                               op=dist.ReduceOp.SUM, group=group)
    total = total / dist.get_world_size(group)
    return total[:E], total[E:2 * E], total[2 * E]


def _dense_moe(p: MoE, x_flat: torch.Tensor, cfg: MoEConfig, group=None):
    """All-experts compute, gate-weighted combine. x_flat: (N, d)."""
    topk_idx, topk_w, aux = _router(p, x_flat, cfg, group)
    N, d = x_flat.shape
    E = cfg.num_experts
    gates = torch.zeros((N, E), device=x_flat.device).scatter_(
        1, topk_idx, topk_w)  # the reference's one-hot sum: k distinct experts
    dt = x_flat.dtype
    ye = _expert_ffn(p.wi_gate.to(dt), p.wi_up.to(dt), p.wo.to(dt),
                     x_flat[None].expand(E, N, d))  # (E, N, d)
    # (N, 1, E) @ (N, E, d): each token's gate-weighted sum over experts.
    out = torch.matmul(gates.to(dt)[:, None], ye.transpose(0, 1))[:, 0]
    return out, aux


def dispatch_slots(topk_idx: torch.Tensor, e_lo: int, E_loc: int, C: int):
    """One model shard's slots: ``(keep, dest_e, dest_c)`` over the N·k
    routed slots (token-major).  A slot is this shard's when its expert
    lies in [e_lo, e_lo + E_loc); its position in its expert's queue is
    the count of earlier slots routed there (the reference's cumulative
    one-hot sum), and it is kept when that position is below the
    capacity ``C``.  Dropped and foreign slots point at the trash expert
    ``E_loc``, position 0."""
    slot_e = topk_idx.reshape(-1)
    mine = (slot_e >= e_lo) & (slot_e < e_lo + E_loc)
    local_e = torch.where(mine, slot_e - e_lo, torch.full_like(slot_e, E_loc))
    onehot = F.one_hot(local_e, E_loc + 1).to(torch.int32)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(1)
    keep = mine & (pos < C)
    dest_e = torch.where(keep, local_e, torch.full_like(local_e, E_loc))
    dest_c = torch.where(keep, pos, torch.zeros_like(pos))
    return keep, dest_e, dest_c


def _local_dispatch_ffn(w_gate, w_up, w_out, x, topk_idx, topk_w, e_lo: int,
                        E_loc: int, C: int, dt):
    """One model shard's expert work: the tokens routed to its experts,
    up to ``C`` a expert, through their FFN and back, weighted by their
    gates.  x: (N, d), replicated over ``model``; the weights are this
    shard's (E_loc, ...) slab.  Returns the (N, d) partial output (zero
    for tokens this shard does not serve), to be summed over ``model``.
    The dispatch is the reference's scatter-add into a (E_loc + 1, C, d)
    buffer whose last expert collects the dropped and foreign slots
    (zeros), so no step waits for the host; the combine rounds as the
    reference's does, each slot's output times its gate in ``dt`` and
    added into zeros slot by slot."""
    N, d = x.shape
    k = topk_idx.shape[1]
    keep, dest_e, dest_c = dispatch_slots(topk_idx, e_lo, E_loc, C)
    slot_tok = torch.arange(N * k, device=x.device) // k
    buf = torch.zeros((E_loc + 1, C, d), dtype=dt, device=x.device)
    rows = torch.where(keep[:, None], x[slot_tok].to(dt), torch.zeros((), dtype=dt,
                                                                     device=x.device))
    buf.index_put_((dest_e, dest_c), rows, accumulate=True)
    y = _expert_ffn(w_gate.to(dt), w_up.to(dt), w_out.to(dt), buf[:E_loc])
    y = torch.cat([y, torch.zeros((1, C, d), dtype=y.dtype, device=y.device)])
    gathered = y[dest_e, dest_c]                       # (N·k, d)
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    gathered = (gathered * topk_w.reshape(-1)[:, None].to(dt)).view(N, k, d)
    out = gathered[:, 0]
    for j in range(1, k):
        out = out + gathered[:, j]
    return out


def _ep_moe(p: MoE, x_flat: torch.Tensor, cfg: MoEConfig, ctx: ShardCtx):
    """Expert parallelism over ``ctx.mesh``'s ``model`` axis (the
    reference's ``_ep_moe``): tokens split over the batch axes where they
    divide, experts over ``model``; the aux averaged over both."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import axis_size, batch_axes

    mesh = ctx.mesh
    E_loc = cfg.num_experts // mesh.shape["model"]
    N = x_flat.shape[0]
    bd = batch_axes(mesh)
    n_tok = axis_size(mesh, bd)
    N_loc = N // n_tok if N % n_tok == 0 else N
    tok_spec = bd if N % n_tok == 0 else ()
    C = max(int(N_loc * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 8)

    def body(x_loc, router_w, wi_gate, wi_up, wo):
        e_lo = spmd.axis_index("model") * E_loc
        topk_idx, topk_w, aux = _router(types.SimpleNamespace(router=router_w),
                                        x_loc, cfg)
        partial = _local_dispatch_ffn(wi_gate, wi_up, wo, x_loc, topk_idx,
                                      topk_w, e_lo, E_loc, C, x_loc.dtype)
        out = spmd.psum(partial, "model")
        aux = spmd.pmean(aux, "model")
        if tok_spec:
            aux = spmd.pmean(aux, tok_spec)
        return out, aux

    P = spmd.P
    slab = P("model", None, None)
    return spmd.shard_map(
        body, mesh,
        in_specs=(P(tok_spec or None, None), P(None, None), slab, slab, slab),
        out_specs=(P(tok_spec or None, None), P()),
    )(x_flat, p.router, p.wi_gate, p.wi_up, p.wo)


def _moe_partial(p: MoE, x_flat: torch.Tensor, cfg: MoEConfig, ctx: ShardCtx,
                 impl: str):
    """This rank's share of the MoE under tensor parallelism (``ctx.tp``;
    ``x_flat`` (N, d) whole on the model group): EP over the group where
    it divides the experts (``auto``, ``ep``), else (``dense``, or experts
    the group does not divide) the dense MoE, which the group's first
    rank contributes whole.  The shared experts are column- and
    row-parallel.  Returns (the partial output, the aux loss)."""
    tp = ctx.tp
    E = cfg.num_experts
    ep = impl == "ep" or (impl == "auto" and E % tp.size == 0)
    if ep and E % tp.size:
        raise ValueError(f"moe_ffn(impl='ep'): {E} experts do not split over "
                         f"a model axis of {tp.size}")
    dt = x_flat.dtype
    if ep:
        E_loc = E // tp.size
        N = x_flat.shape[0]
        C = max(int(N * cfg.top_k * cfg.capacity_factor / E), 8)
        topk_idx, topk_w, aux = _router(
            types.SimpleNamespace(router=tp.copy_to(p.router)), x_flat, cfg)
        out = _local_dispatch_ffn(p.wi_gate, p.wi_up, p.wo, x_flat, topk_idx,
                                  topk_w, tp.index * E_loc, E_loc, C, dt)
    else:
        whole = types.SimpleNamespace(**{k: tp.copy_to(getattr(p, k)) for k in
                                         ("router", "wi_gate", "wi_up", "wo")})
        out, aux = _dense_moe(whole, x_flat, cfg, ctx.batch_group)
        out = out * (1.0 if tp.index == 0 else 0.0)
    if p.shared is not None:
        sh = p.shared
        s_out = mlp_partial(sh.wi_gate, sh.wi_up, sh.wo, x_flat, tp,
                            cfg.expert_ffw_dim * cfg.num_shared_experts)
        s_gate = torch.sigmoid(torch.matmul(x_flat, tp.copy_to(sh.gate).to(dt)))
        out = out + s_out * s_gate
    return out, tp.once(aux)


def _use_ep(impl: str, cfg: MoEConfig, ctx: ShardCtx) -> bool:
    """The reference's choice: ``ep`` when asked, and under ``auto`` when
    the mesh has a ``model`` axis that divides the experts."""
    if impl == "ep":
        return True
    mesh = ctx.mesh
    return (impl == "auto" and mesh is not None
            and "model" in mesh.axis_names
            and cfg.num_experts % mesh.shape["model"] == 0)


def moe_ffn(p: MoE, x: torch.Tensor, cfg: MoEConfig, ctx: ShardCtx = NULL_CTX,
            impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  ``dense`` computes every expert;
    ``ep`` shards experts over ``ctx.mesh``'s ``model`` axis (a dispatch
    mesh: it serves, and raises under autograd); ``auto`` picks ``ep``
    where the reference does.  Under the trainer's tensor parallelism
    (``ctx.tp``; ``x`` whole on the model group, from ``tp.enter``) it
    returns this rank's partial output instead (:func:`_moe_partial`),
    which the caller sums over the group (``tp.leave``)."""
    if impl not in ("auto", "dense", "ep"):
        raise ValueError(f"unknown MoE impl {impl!r}")
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    if ctx.tp is not None:
        out, aux = _moe_partial(p, x_flat, cfg, ctx, impl)
        return out.reshape(B, S, d), aux
    if _use_ep(impl, cfg, ctx):
        if ctx.mesh is None or "model" not in ctx.mesh.axis_names:
            raise ValueError("moe_ffn(impl='ep') needs ctx.mesh with a "
                             "'model' axis (a dispatch mesh)")
        if torch.is_grad_enabled() and (x.requires_grad or any(
                t.requires_grad for t in (p.router, p.wi_gate, p.wi_up, p.wo))):
            raise NotImplementedError(
                "moe_ffn(impl='ep') under autograd on a dispatch mesh: its "
                "shard threads serve only (ROADMAP §1); the trained EP runs "
                "on a rank mesh with a model axis (ShardCtx.tp, launch.mesh."
                "make_rank_mesh(model_axis=M))")
        out, aux = _ep_moe(p, x_flat, cfg, ctx)
    else:
        out, aux = _dense_moe(p, x_flat, cfg, ctx.batch_group)
    if p.shared is not None:
        sh = p.shared
        s_out = mlp(sh.wi_gate, sh.wi_up, sh.wo, x_flat)
        s_gate = torch.sigmoid(torch.matmul(x_flat, sh.gate.to(x.dtype)))
        out = out + s_out * s_gate
    return out.reshape(B, S, d), aux

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

Expert parallelism (the reference's ``impl="ep"``: ``_ep_moe`` and
``_local_dispatch_ffn`` over a mesh ``model`` axis) is not ported yet;
``impl="ep"`` raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import MoEConfig
from repro_torch.models.common import mlp, param


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


def _router(p: MoE, x: torch.Tensor, cfg: MoEConfig):
    """(topk_idx (N, k), topk_w (N, k) float32, aux scalar). x: (N, d)."""
    logits = torch.matmul(x, p.router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: equal values in index order (bf16 logits tie often).
    topk_w, topk_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_idx = topk_w[:, :cfg.top_k], topk_idx[:, :cfg.top_k]
    topk_w = topk_w / topk_w.sum(-1, keepdim=True)
    E = cfg.num_experts
    me = probs.mean(0)
    ce = F.one_hot(topk_idx, E).sum(1).float().mean(0) / cfg.top_k
    lb = E * torch.sum(me * ce)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = cfg.aux_loss_weight * (lb + 1e-3 * z)
    return topk_idx, topk_w, aux


def _dense_moe(p: MoE, x_flat: torch.Tensor, cfg: MoEConfig):
    """All-experts compute, gate-weighted combine. x_flat: (N, d)."""
    topk_idx, topk_w, aux = _router(p, x_flat, cfg)
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


def moe_ffn(p: MoE, x: torch.Tensor, cfg: MoEConfig,
            impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  ``auto`` and ``dense`` run the
    dense path (the port has no ``model`` mesh axis to shard experts
    over); ``ep`` raises."""
    if impl == "ep":
        raise NotImplementedError(
            "moe_ffn(impl='ep'): expert parallelism (the JAX package's "
            "_ep_moe / _local_dispatch_ffn over a mesh 'model' axis) is not "
            "ported yet")
    if impl not in ("auto", "dense"):
        raise ValueError(f"unknown MoE impl {impl!r}")
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    out, aux = _dense_moe(p, x_flat, cfg)
    if p.shared is not None:
        sh = p.shared
        s_out = mlp(sh.wi_gate, sh.wi_up, sh.wo, x_flat)
        s_gate = torch.sigmoid(torch.matmul(x_flat, sh.gate.to(x.dtype)))
        out = out + s_out * s_gate
    return out.reshape(B, S, d), aux

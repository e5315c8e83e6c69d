"""Exact pair-collapse execution of snapped attention (DESIGN.md §2, §4).

If a window of K tokens is snapped to identical values, its pre-softmax
attention columns are identical, so softmax can fold them into one
representative column with integer multiplicity in the denominator and a
window-summed V row in the numerator::

    softmax([s, s]) · [v0; v1]  ==  (exp(s)·(v0+v1)) / (2·exp(s) + …)

Symmetrically, a window of identically-snapped Q rows needs one computed
output row (the followers copy it).  Both identities are exact.
:func:`collapsed_attention` is the plain-PyTorch ``collapse`` backend of
the dispatch layer; the FLOP savings are realized by the CUDA ripple
kernel (``kernels/ripple``), which skips collapsed tiles.

Collapse requires window partners adjacent in token order; use
:func:`pair_major_order` to permute a (t, y, x) grid so partners along a
chosen axis become adjacent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def pair_flags(snapped: torch.Tensor, window: int = 2) -> torch.Tensor:
    """True for each window whose members are value-identical.

    snapped: (..., N, d); returns (..., N // window) bool.  Uses value
    equality so it is correct regardless of which axis produced the snap.
    """
    *lead, N, d = snapped.shape
    n = N // window
    w = snapped[..., : n * window, :].reshape(*lead, n, window, d)
    return (w == w[..., :1, :]).all(dim=-1).all(dim=-1)


def pair_major_order(grid: Tuple[int, int, int], axis: str,
                     window: int = 2) -> np.ndarray:
    """Permutation making ``window`` partners along ``axis`` adjacent.

    Token order is (t, y, x) row-major. Returns ``perm`` with
    ``x_pair_major = x[..., perm, :]``; invert with ``argsort(perm)``.
    """
    T, H, W = grid
    idx = np.arange(T * H * W).reshape(T, H, W)
    if axis == "t":
        n = T // window
        head = idx[: n * window].reshape(n, window, H, W)
        head = np.moveaxis(head, 1, -1)  # (n, H, W, window)
        perm = np.concatenate([head.reshape(-1), idx[n * window:].reshape(-1)])
    elif axis == "y":
        n = H // window
        head = idx[:, : n * window].reshape(T, n, window, W)
        head = np.moveaxis(head, 2, -1)
        perm = np.concatenate([head.reshape(-1),
                               idx[:, n * window:].reshape(-1)])
    elif axis == "x":
        perm = idx.reshape(-1)  # x partners are already adjacent
    else:
        raise ValueError(axis)
    return perm


def collapsed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, k_collapse: Optional[torch.Tensor] = None,
                        q_collapse: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        bias: Optional[torch.Tensor] = None,
                        window: int = 2) -> torch.Tensor:
    """Weighted-softmax attention with window collapse.

    q: (..., Nq, d), k: (..., Nk, d), v: (..., Nk, dv).  ``k_collapse`` /
    ``q_collapse`` are per-window bools (from :func:`pair_flags`); None
    recomputes them from value equality.  ``bias`` is an additive logit
    bias (..., Nq, Nk); collapse assumes it is window-constant over
    collapsed K windows.

    Rounding follows the JAX package: the logits come out of the product
    in the operands' dtype and are scaled (the scale rounded to that
    dtype first, as a JAX weak-typed scalar is) and biased there, then
    taken to float32; the output is cast to v's dtype.
    """
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]))).to(q.dtype)
    if k_collapse is None:
        k_collapse = pair_flags(k, window)
    if q_collapse is None:
        q_collapse = pair_flags(q, window)

    *lead, Nq, _ = q.shape
    Nk = k.shape[-2]
    nk = Nk // window
    dv = v.shape[-1]

    logits = torch.matmul(q, k.transpose(-1, -2))
    logits = logits * torch.as_tensor(scale).to(logits.dtype)
    if bias is not None:
        logits = logits + bias
    logits = logits.float()

    # --- K-side collapse: fold member columns into the representative. ---
    head = logits[..., : nk * window].reshape(*lead, Nq, nk, window)
    rep_logit = head[..., 0]
    m = head.amax(dim=-1).amax(dim=-1, keepdim=True)
    if Nk > nk * window:
        m = torch.maximum(m, logits[..., nk * window:].amax(dim=-1,
                                                             keepdim=True))

    v_head = v[..., : nk * window, :].reshape(*lead, nk, window, dv)
    v_sum = v_head.sum(dim=-2)  # in v's dtype, as jnp.sum
    exp_head = torch.exp(head - m[..., None])
    exp_rep = torch.exp(rep_logit - m)
    kc = k_collapse[..., None, :]  # (..., 1, nk) broadcast over q
    # collapsed window: weight = window·exp(rep); numerator exp(rep)·Σv
    z_win = torch.where(kc, window * exp_rep, exp_head.sum(dim=-1))
    num_win = torch.where(
        kc[..., None],
        exp_rep[..., None] * v_sum[..., None, :, :].float(),
        torch.einsum("...qkw,...kwv->...qkv", exp_head, v_head.float()),
    )
    z = z_win.sum(dim=-1)
    num = num_win.sum(dim=-2)
    if Nk > nk * window:
        tail_exp = torch.exp(logits[..., nk * window:] - m)
        z = z + tail_exp.sum(dim=-1)
        num = num + torch.matmul(tail_exp, v[..., nk * window:, :].float())
    out = (num / z[..., None]).to(v.dtype)

    # --- Q-side collapse: followers copy the representative's output. ---
    nq = Nq // window
    if nq > 0:
        head_out = out[..., : nq * window, :].reshape(*lead, nq, window, dv)
        qc = q_collapse[..., :, None, None]
        head_out = torch.where(qc, head_out[..., :1, :].expand_as(head_out),
                               head_out)
        out = torch.cat([head_out.reshape(*lead, nq * window, dv),
                         out[..., nq * window:, :]], dim=-2)
    return out

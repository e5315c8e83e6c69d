"""Compute-savings accounting for TimeRipple (paper-faithful form).

A partial score ``q_{i,c}·k_{j,c}`` must be computed only when neither
operand entry is a snapped copy:

    computed(c) = (1 − fq_c) · (1 − fk_c)
    saved       = 1 − mean_c computed(c)

where ``fq_c``/``fk_c`` are the snapped fractions of Q/K at channel c.

The *structural* savings of the collapse path (DESIGN.md §4), which also
saves softmax and AV work for fully collapsed pairs, are reported
separately (:func:`collapse_savings`); the paper's accounting never
includes AV.
"""

from __future__ import annotations

from typing import Tuple

import torch


def partial_score_savings(q_mask: torch.Tensor, k_mask: torch.Tensor
                          ) -> torch.Tensor:
    """Paper-faithful savings ratio from boolean snap masks (..., N, d)."""
    fq = q_mask.float().mean(dim=-2)  # (..., d)
    fk = k_mask.float().mean(dim=-2)
    computed = ((1.0 - fq) * (1.0 - fk)).mean(dim=-1)
    return 1.0 - computed.mean()


def pair_collapse_fractions(q_mask: torch.Tensor, k_mask: torch.Tensor,
                            window: int = 2
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fractions of Q windows / K windows whose followers are fully snapped.

    A window collapses only when every non-representative member is
    snapped on **all** channels; masks are (..., N, d) with tokens in
    pair-major order along the collapse axis (caller's responsibility).
    """

    def frac(mask):
        *lead, N, d = mask.shape
        n = N // window
        m = mask[..., : n * window, :].reshape(*lead, n, window, d)
        full = m[..., 1:, :].all(dim=-1).all(dim=-1)  # followers only
        return full.float().mean()

    return frac(q_mask), frac(k_mask)


def collapse_savings(q_mask: torch.Tensor, k_mask: torch.Tensor,
                     window: int = 2) -> torch.Tensor:
    """Structural FLOP savings of the collapse execution path.

    With fraction pq of Q windows and pk of K windows collapsed, each
    collapsed window does 1/window of the work:

        rows = 1 − pq·(window−1)/window,  cols = 1 − pk·(window−1)/window
        savings = 1 − rows · cols
    """
    pq, pk = pair_collapse_fractions(q_mask, k_mask, window)
    shrink = (window - 1) / window
    return 1.0 - (1.0 - pq * shrink) * (1.0 - pk * shrink)


def attention_flops(n_q: int, n_k: int, d: int, d_v: int, heads: int,
                    batch: int = 1) -> int:
    """Dense self-attention matmul FLOPs (QKᵀ + AV), multiply+add = 2."""
    return batch * heads * (2 * n_q * n_k * d + 2 * n_q * n_k * d_v)


def theoretical_speedup(attn_fraction: float, savings):
    """End-to-end speedup the paper reports: self-attention is
    ``attn_fraction`` of total latency (paper Fig. 4: ~0.78 on average)
    and ``savings`` of it is skipped; the rest of the model is untouched.
    """
    return 1.0 / (1.0 - attn_fraction * savings)

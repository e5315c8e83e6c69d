"""Compute-savings accounting for TimeRipple (paper-faithful form).

A partial score ``q_{i,c}·k_{j,c}`` must be computed only when neither
operand entry is a snapped copy:

    computed(c) = (1 − fq_c) · (1 − fk_c)
    saved       = 1 − mean_c computed(c)

where ``fq_c``/``fk_c`` are the snapped fractions of Q/K at channel c.
"""

from __future__ import annotations

import torch


def partial_score_savings(q_mask: torch.Tensor, k_mask: torch.Tensor
                          ) -> torch.Tensor:
    """Paper-faithful savings ratio from boolean snap masks (..., N, d)."""
    fq = q_mask.float().mean(dim=-2)  # (..., d)
    fk = k_mask.float().mean(dim=-2)
    computed = ((1.0 - fq) * (1.0 - fk)).mean(dim=-1)
    return 1.0 - computed.mean()

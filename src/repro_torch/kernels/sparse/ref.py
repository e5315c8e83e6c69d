"""Plain PyTorch version of the block-sparse masked attention kernel.

Reproduces the kernel's block-map semantics: SKIP tiles contribute
nothing, FULL tiles ignore the bias, PARTIAL tiles add it; rows whose
every tile is skipped (or fully −inf-masked) emit zeros rather than NaN,
matching the kernel's finite running-max convention.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Block-map states (int32).
SKIP, FULL, PARTIAL = 0, 1, 2


def sparse_grid(n_q: int, n_k: int, block_q: int,
                block_k: int) -> Tuple[int, int, int, int]:
    """Effective (block_q, block_k, nq, nk) for a (n_q, n_k) score map.

    The one clamping rule shared by the kernel wrapper, this plain
    version and the policies' block-map builders: every side must tile
    the score map identically or the map rides on the wrong tiles.
    """
    bq = min(block_q, max(n_q, 1))
    bk = min(block_k, max(n_k, 1))
    return bq, bk, -(-n_q // bq), -(-n_k // bk)


def expand_block_map(block_map: torch.Tensor, n_q: int, n_k: int,
                     block_q: int, block_k: int) -> torch.Tensor:
    """Broadcast tile states back to a token-level (..., n_q, n_k) map."""
    bq, bk, nq, nk = sparse_grid(n_q, n_k, block_q, block_k)
    if tuple(block_map.shape[-2:]) != (nq, nk):
        raise ValueError(f"block map {tuple(block_map.shape)} does not tile "
                         f"({n_q}, {n_k}) into ({nq}, {nk}) blocks")
    e = block_map.repeat_interleave(bq, dim=-2).repeat_interleave(bk, dim=-1)
    return e[..., :n_q, :n_k]


def sparse_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, bias: Optional[torch.Tensor] = None,
                         block_map: Optional[torch.Tensor] = None,
                         block_q: int = 128, block_k: int = 128,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (..., Nq, d), k: (..., Nk, d), v: (..., Nk, dv) -> (..., Nq, dv).

    ``block_map`` (..., nq, nk) int states; None means every tile is
    PARTIAL when a bias exists (dense masked attention) and FULL
    otherwise — the same degradation the kernel wrapper applies.  The
    logits come out of the product in the operands' dtype, as in the JAX
    oracle.
    """
    n_q, n_k = q.shape[-2], k.shape[-2]
    if scale is None:
        scale = float(1.0 / (q.shape[-1] ** 0.5))
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if block_map is None:
        if bias is not None:
            s = s + bias.float()
    else:
        st = expand_block_map(block_map, n_q, n_k, block_q, block_k)
        if bias is not None:
            s = torch.where(st == PARTIAL, s + bias.float(), s)
        s = s.masked_fill(st == SKIP, float("-inf"))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float())
    return (out / torch.where(l > 0.0, l, torch.ones_like(l))).to(q.dtype)

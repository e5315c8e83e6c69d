"""Plain PyTorch version of the block-sparse masked attention kernel.

Reproduces the kernel's block-map semantics: SKIP tiles contribute
nothing, FULL tiles ignore the bias, PARTIAL tiles add it; rows whose
every tile is skipped (or fully −inf-masked) emit zeros rather than NaN,
matching the kernel's finite running-max convention; and its
``carry`` / ``return_state`` contract (the online-softmax state a ring
hop hands to the next).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Block-map states (int32).
SKIP, FULL, PARTIAL = 0, 1, 2
# The running max's start: finite, so a row whose every key is masked
# stays finite (the JAX kernel's _M_INIT, csrc/sparse_attention.cu's
# kMInit).
M_INIT = -1e30


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


def fresh_state(lead, n_q: int, dv: int, device=None):
    """The online softmax's starting state ``(m, l, acc)``: m at the
    kernel's finite ``M_INIT``, l and acc zero, all float32."""
    f32 = torch.float32
    return (torch.full((*lead, n_q), M_INIT, dtype=f32, device=device),
            torch.zeros((*lead, n_q), dtype=f32, device=device),
            torch.zeros((*lead, n_q, dv), dtype=f32, device=device))


def finalize(acc: torch.Tensor, l: torch.Tensor, dtype) -> torch.Tensor:
    """``acc / l`` with rows of l == 0 (every key skipped or masked) at
    zero, never NaN, rounded to ``dtype``."""
    return (acc / torch.where(l > 0.0, l, torch.ones_like(l))[..., None]) \
        .to(dtype)


def sparse_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, bias: Optional[torch.Tensor] = None,
                         block_map: Optional[torch.Tensor] = None,
                         block_q: int = 128, block_k: int = 128,
                         scale: Optional[float] = None, carry=None,
                         return_state: bool = False):
    """q: (..., Nq, d), k: (..., Nk, d), v: (..., Nk, dv) -> (..., Nq, dv).

    ``block_map`` (..., nq, nk) int states; None means every tile is
    PARTIAL when a bias exists (dense masked attention) and FULL
    otherwise — the same degradation the kernel wrapper applies.  The
    logits come out of the product in the operands' dtype, as in the JAX
    oracle.

    The softmax runs online over the key tiles in ascending order, as the
    kernels do: per tile the running max ``m``, the row sum ``l`` and the
    f32 accumulator ``acc`` are rescaled and updated; a SKIP tile is
    passed over.  ``carry = (m, l, acc)`` ((..., Nq) f32 twice, (...,
    Nq, dv) f32) resumes from an earlier call's state (the ring's
    cross-hop accumulator, DESIGN.md §14), and ``return_state`` returns
    ``(out, (m, l, acc))``.  Every tile is the same computation whether
    it comes in one call or in a chain of calls over whole key tiles, so
    such a chain equals one call bit for bit.
    """
    n_q, n_k = q.shape[-2], k.shape[-2]
    dv = v.shape[-1]
    if scale is None:
        scale = float(1.0 / (q.shape[-1] ** 0.5))
    bq, bk, nq, nk = sparse_grid(n_q, n_k, block_q, block_k)
    lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2], v.shape[:-2])
    if carry is None:
        m, l, acc = fresh_state(lead, n_q, dv, q.device)
    else:
        m, l, acc = (t.float() for t in carry)
        if (tuple(m.shape) != (*lead, n_q) or tuple(l.shape) != tuple(m.shape)
                or tuple(acc.shape) != (*lead, n_q, dv)):
            raise ValueError(f"carry shapes {[tuple(t.shape) for t in carry]}"
                             f" do not match {(*lead, n_q)} / "
                             f"{(*lead, n_q, dv)}")
    if block_map is not None and tuple(block_map.shape[-2:]) != (nq, nk):
        raise ValueError(f"block map {tuple(block_map.shape)} does not tile "
                         f"({n_q}, {n_k}) into ({nq}, {nk}) blocks")
    for j in range(nk):
        lo, hi = j * bk, min((j + 1) * bk, n_k)
        if block_map is None:
            rows = None
        else:
            # This key tile's state for every query row.
            rows = block_map[..., :, j].repeat_interleave(bq, dim=-1)[..., :n_q]
            if not bool((rows != SKIP).any()):
                continue
        kj = k[..., lo:hi, :].contiguous()
        vj = v[..., lo:hi, :].contiguous()
        s = torch.matmul(q, kj.transpose(-1, -2)).float() * scale
        if bias is not None:
            bj = bias[..., lo:hi].float()
            s = s + bj if rows is None else \
                torch.where((rows == PARTIAL)[..., None], s + bj, s)
        if rows is not None:
            s = s.masked_fill((rows == SKIP)[..., None], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.matmul(p, vj.float())
        m = m_new
    out = finalize(acc, l, q.dtype)
    return (out, (m, l, acc)) if return_state else out

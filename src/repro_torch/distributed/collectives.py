"""Int8 gradient compression with error feedback (the JAX package's
``distributed/collectives.py``).

Per-tensor symmetric int8 quantization cuts the bytes a gradient
reduction moves 4x against float32.  Error feedback keeps the
quantization residual and adds it back the next step, so the noise
telescopes and SGD still converges.  The transform runs where the
reference runs it: after micro-batch accumulation and before AdamW,
q(dq(g) + e), with the residual e carried in the train state.

The arithmetic is the reference's as XLA compiles it under ``jit``: the
scale is ``max(max|x|, 1e-12)`` times the float32 reciprocal of 127
(XLA rewrites the division by a constant into that product), values are
divided by the scale and rounded half to even (``torch.round``, as
``jnp.round``), and the residual is rounded once from the exact
``g - q * scale`` where XLA fuses the multiply and the subtraction, so the
result is bit-equal to the jitted reference on any device.
With gradients sharded over ranks, ``max|x|`` is the maximum over every
shard of the tensor (``reduce_max``), so each shard quantizes with the
scale the whole tensor has.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["CompressionState", "compress_grads", "compressed_bytes",
           "compression_init", "dequantize_int8", "quantize_int8"]

# 1/127 in float32: what XLA multiplies by for the reference's ``/ 127.0``.
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


class CompressionState(NamedTuple):
    """The float32 residual of each gradient (a list aligned with the
    parameters)."""

    error: List[torch.Tensor]


def compression_init(params: List[torch.Tensor]) -> CompressionState:
    return CompressionState(error=[
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in params])


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax.float(), min=1e-12) * _INV_127.to(amax.device)


def quantize_int8(x: torch.Tensor, reduce_max: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: (q int8, scale float32
    scalar).  ``reduce_max(t)`` turns this shard's ``max|x|`` into the
    whole tensor's (an all-reduce over the ranks that hold its
    shards)."""
    amax = torch.amax(torch.abs(x)) if x.numel() else torch.zeros(
        (), dtype=x.dtype, device=x.device)
    if reduce_max is not None:
        amax = reduce_max(amax)
    scale = _scale(amax)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _residual(g32: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
              ) -> torch.Tensor:
    """g32 - q * scale as the jitted reference computes ``g32 - dq``: XLA
    on the CPU fuses the multiply and the subtraction into one rounding
    for every tensor of two or more elements (in float64 the product of
    a 7-bit integer and a float32 and the difference of two nearby
    values are exact, so the one rounding is the cast back to float32),
    and rounds twice for a one-element tensor."""
    if g32.numel() == 1:
        return g32 - dequantize_int8(q, scale)
    return (g32.double() - q.double() * scale.double()).float()


@torch.no_grad()
def compress_grads(grads: List[torch.Tensor], state: CompressionState,
                   reduce_max: Optional[Callable] = None):
    """Error-feedback int8 round trip of each gradient: returns (the
    decompressed gradients, each in its gradient's dtype, and the new
    residual state).  The int8 tensor is what a compressed reduction
    would move."""
    out, errors = [], []
    for g, e in zip(grads, state.error):
        g32 = g.float() + e
        q, s = quantize_int8(g32, reduce_max)
        out.append(dequantize_int8(q, s).to(g.dtype))
        errors.append(_residual(g32, q, s))
    return out, CompressionState(error=errors)


def compressed_bytes(grads: List[torch.Tensor]) -> int:
    """Bytes an int8-compressed reduce moves: one byte an element and a
    float32 scale a tensor."""
    return sum(int(g.numel()) for g in grads) + 4 * len(grads)

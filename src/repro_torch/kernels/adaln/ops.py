"""Wrapper of the fused adaLN modulation kernel (``csrc/adaln.cu``).

``adaln_modulate(x, shift, scale)`` computes
``LayerNorm(x) * (1 + scale) + shift`` per token row, with the (B, d)
conditioning vectors of each sample.  On a CUDA tensor it launches the
kernel or raises; on a CPU tensor, and only there, it runs the plain
version (``ref.py``).  Rows are independent, so any N is taken as it is.
``launches`` counts kernel launches.

On CUDA, when an operand requires grad under grad mode, the kernel runs
inside an autograd Function (``_AdaLN``), so a training step's gradients
pass through it (serving launches it directly, without the Function's
host cost): the forward is the kernel,
the backward the closed-form gradient of LayerNorm-then-modulate in
PyTorch ops (:func:`adaln_modulate_grads`), recomputing mean and rstd
from the saved x.  The JAX package has no backward kernel (its
``kernels/adaln`` has no ``custom_vjp``, and its DiT modulates inline),
so none is written here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (LAUNCH_LOCK, _build, count_call, counts,
                                 misaligned, on_card)
from repro_torch.kernels.adaln.ref import adaln_modulate_ref
from repro_torch.launch.roofline import adaln_work

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _cond(t: torch.Tensor, x: torch.Tensor):
    """A (B, d) conditioning vector as the kernel reads it, and its stride
    between samples: unit stride along d, every sample's row aligned like
    a row of x (a chunk of the adaLN projection already is; anything else
    is copied)."""
    B, d = t.shape
    if t.stride(-1) != 1 or misaligned(t, 4 * x.element_size()) or \
            (B > 1 and (t.stride(0) % 4 or t.stride(0) < d)):
        t = t.contiguous()
    return t, t.stride(0) if B > 1 else d


def _launch(x, shift, scale, eps: float):
    global launches
    B, N, d = x.shape
    for name, t in (("shift", shift), ("scale", scale)):
        if t.dtype != x.dtype:
            raise TypeError(f"adaln kernel takes one dtype; x is {x.dtype}, "
                            f"{name} is {t.dtype}")
        if t.shape != (B, d):
            raise ValueError(f"{name} must be (B, d) = {(B, d)}, not "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("adaln kernel operands must share a device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"adaln kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if not x.is_contiguous() or misaligned(x, 4 * x.element_size()):
        raise ValueError("adaln kernel needs a contiguous, aligned x")
    if counts(x):  # a dry run's fake operand: counted, not launched
        count_call("adaln", adaln_work(x.shape, x.element_size()))
        return torch.empty_like(x)
    lib = _build.load("adaln")
    if d % 4 or d > lib.adaln_max_dim():
        raise ValueError(f"adaln kernel takes d % 4 == 0 and d <= "
                         f"{lib.adaln_max_dim()}, not {d}")
    (shift, sh_stride), (scale, sc_stride) = _cond(shift, x), _cond(scale, x)
    out = torch.empty_like(x)
    fn = _build.function("adaln", "adaln_launch",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                         + [ctypes.c_long] * 2
                         + [ctypes.c_float, ctypes.c_void_p])
    with _build.on_device(x):  # launch on the operand's card
        rc = fn(x.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                out.data_ptr(), _DTYPES[x.dtype], B, N, d, sh_stride,
                sc_stride, eps, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adaln kernel launch failed: CUDA error {rc}")
    with LAUNCH_LOCK:
        launches += 1
    return out


def adaln_modulate_grads(x: torch.Tensor, scale: torch.Tensor,
                         g: torch.Tensor, eps: float = 1e-6):
    """(dx, dshift, dscale) of ``LayerNorm(x) * (1 + scale) + shift``
    for the output gradient g (B, N, d), in float32 and rounded to each
    operand's dtype: with n̂ = (x − mean) · rstd and g′ = g · (1 + scale),
    dshift = Σ_N g, dscale = Σ_N g · n̂ and
    dx = rstd · (g′ − mean_d(g′) − n̂ · mean_d(g′ · n̂))."""
    x32, g32 = x.float(), g.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    rstd = torch.rsqrt(var + eps)
    nhat = (x32 - mu) * rstd
    dshift = g32.sum(dim=1)
    dscale = (g32 * nhat).sum(dim=1)
    gp = g32 * (1.0 + scale[:, None, :].float())
    dx = rstd * (gp - gp.mean(dim=-1, keepdim=True)
                 - nhat * (gp * nhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dshift.to(scale.dtype), dscale.to(scale.dtype)


class _AdaLN(torch.autograd.Function):
    """The kernel as the forward; :func:`adaln_modulate_grads` as the
    backward."""

    @staticmethod
    def forward(ctx, x, shift, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.shift_dtype = shift.dtype
        return _launch(x, shift, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dshift, dscale = adaln_modulate_grads(x, scale, g, ctx.eps)
        return dx, dshift.to(ctx.shift_dtype), dscale, None


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor,
                   scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (B, N, d); shift/scale: (B, d) -> (B, N, d) in x's dtype."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, d), not {tuple(x.shape)}")
    if x.device.type == "cpu" and not counts(x):
        return adaln_modulate_ref(x, shift, scale, eps)
    if not on_card(x):
        raise ValueError(f"adaln kernel runs on CUDA, not {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, shift, scale)):
        return _AdaLN.apply(x, shift, scale, float(eps))
    return _launch(x, shift, scale, float(eps))  # serving: no graph

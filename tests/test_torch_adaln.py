"""Parity of the port's fused adaLN modulation wrapper (its plain version
on CPU tensors) with the JAX Pallas kernel in interpret mode and with the
JAX oracle, on numpy inputs from a seed: every sample of a batch has its
own shift and scale, and N need not fill the JAX kernel's row tile."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.adaln.ops import adaln_modulate as j_adaln  # noqa: E402
from repro.kernels.adaln.ref import adaln_modulate_ref as j_ref  # noqa: E402
from repro_torch.kernels.adaln import ops as adaln_ops  # noqa: E402
from repro_torch.kernels.adaln.ops import adaln_modulate  # noqa: E402
from repro_torch.kernels.adaln.ref import adaln_modulate_ref  # noqa: E402

torch.set_num_threads(2)

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, B, N, d, dtype):
    """x, shift, scale drawn in f32 and rounded once to ``dtype``, as
    numpy arrays (f32 values) for both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, N, d), (B, d), (B, d)):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        out.append(a.to(_DT[dtype][0]).float().numpy())
    return out


def _assert_close(got, want, dtype):
    """f32: 1e-5 absolute (summation order of the row statistics and
    rsqrt against 1/sqrt).  bf16: both round one f32 value once, so they
    differ by at most one bf16 ulp of the output's magnitude."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("B,N,d", [(2, 256, 64), (1, 100, 72),
                                   (4, 64, 1152)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_kernel_and_oracle(B, N, d, dtype):
    x, sh, sc = _inputs(B * N + d, B, N, d, dtype)
    tdt, jdt = _DT[dtype]
    got = adaln_modulate(*(torch.from_numpy(a).to(tdt) for a in (x, sh, sc)))
    assert got.dtype == tdt and got.shape == (B, N, d)
    j_in = [jnp.asarray(a).astype(jdt) for a in (x, sh, sc)]
    want_kernel = j_adaln(*j_in, block_t=64, interpret=True)
    want_ref = j_ref(*j_in)
    got32 = got.float().numpy()
    _assert_close(got32, want_kernel.astype(jnp.float32), dtype)
    _assert_close(got32, want_ref.astype(jnp.float32), dtype)
    # The plain version is the port's own ref.
    torch.testing.assert_close(
        got, adaln_modulate_ref(*(torch.from_numpy(a).to(tdt)
                                  for a in (x, sh, sc))), rtol=0, atol=0)


def test_conditioning_views_are_read_in_place():
    """Chunks of the adaLN projection (stride 6d between samples) reach
    the kernel without a copy; a transposed vector is copied."""
    x = torch.zeros((2, 8, 72))
    ada = torch.randn((2, 6 * 72))
    shift = torch.chunk(ada, 6, dim=-1)[1]
    got, stride = adaln_ops._cond(shift, x)
    assert got.data_ptr() == shift.data_ptr() and stride == 6 * 72
    got, stride = adaln_ops._cond(torch.randn((72, 2)).T, x)
    assert got.is_contiguous() and stride == 72
    got, stride = adaln_ops._cond(ada[:1, :72], x)
    assert stride == 72


def test_refuses_devices_it_has_no_kernel_for():
    x = torch.empty((1, 4, 8), device="meta")
    s = torch.empty((1, 8), device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        adaln_modulate(x, s, s)
    with pytest.raises(ValueError, match="must be"):
        adaln_modulate(torch.zeros((4, 8)), torch.zeros((1, 8)),
                       torch.zeros((1, 8)))

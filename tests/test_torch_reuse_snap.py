"""Parity of the port's single-axis pair snap (its plain version on CPU
tensors) with the JAX Pallas kernel in interpret mode: snapped values and
masks bit-equal, the even (representative) half untouched and never
masked."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.reuse_mask.ops import reuse_snap as j_reuse_snap  # noqa: E402
from repro_torch.kernels.reuse_mask import ops as reuse_ops  # noqa: E402
from repro_torch.kernels.reuse_mask.ops import reuse_snap  # noqa: E402

torch.set_num_threads(2)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# tests/test_kernels.py::TestReuseSnapKernel's cases, in both dtypes.
@pytest.mark.parametrize("N,d", [(256, 16), (300, 32), (64, 128)])
@pytest.mark.parametrize("theta", [0.0, 0.3, 10.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bit_equal_to_jax(N, d, theta, dtype):
    x = np.random.default_rng(N + d).standard_normal((2, 2, N, d)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    snapped, mask = reuse_snap(xt, theta)
    j_snapped, j_mask = j_reuse_snap(jnp.asarray(x).astype(getattr(jnp, dtype)),
                                     theta, block=64)
    assert snapped.dtype == xt.dtype and mask.dtype == torch.int8
    np.testing.assert_array_equal(_bits(snapped.float().numpy()),
                                  _bits(j_snapped.astype(jnp.float32)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    # representatives untouched, never masked
    assert torch.equal(snapped[..., 0::2, :], xt[..., 0::2, :])
    assert not mask[..., 0::2, :].any()
    frac = mask[..., 1::2, :].float().mean().item()
    assert frac == (0.0 if theta == 0.0 else 1.0 if theta == 10.0 else frac)
    if theta == 0.3:
        assert 0.1 < frac < 0.6


def test_theta_rounds_to_the_working_type():
    """θ = 0.3 rounds up to 0.30078125 in bf16: a Δ of exactly 0.30078125
    does not snap, one bf16 ulp (2^-9) below it does."""
    th = float(torch.tensor(0.3).bfloat16())
    assert th == 0.30078125
    below = th - 2.0 ** -9
    x = torch.zeros((1, 1, 4, 1), dtype=torch.bfloat16)
    x[0, 0, 1, 0] = 2 * th
    x[0, 0, 3, 0] = 2 * below
    _, mask = reuse_snap(x, 0.3)
    assert mask[0, 0, :, 0].tolist() == [0, 0, 0, 1]


def test_refusals_and_counter():
    reuse_ops.snap_launches = 0
    reuse_snap(torch.randn(1, 1, 4, 8), 0.1)
    assert reuse_ops.snap_launches == 0  # the plain version on the CPU
    with pytest.raises(ValueError, match="N even"):
        reuse_snap(torch.randn(1, 1, 5, 8), 0.1)
    with pytest.raises(ValueError, match="runs on CUDA"):
        reuse_snap(torch.randn(1, 1, 4, 8, device="meta"), 0.1)

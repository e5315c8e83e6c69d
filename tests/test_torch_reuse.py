"""Parity of the PyTorch port's reuse path with the JAX package: the θ
schedule, ``compute_reuse`` and the fused Δ-check wrapper must be
bit-equal (snapped values and masks) on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import RippleConfig as JRippleConfig  # noqa: E402
from repro.core.reuse import compute_reuse as j_compute_reuse  # noqa: E402
from repro.core.schedule import threshold_for_step as j_threshold  # noqa: E402
from repro.kernels.reuse_mask.ops import (  # noqa: E402
    fused_compute_reuse as j_fused_compute_reuse,
    fused_reuse_eligible as j_eligible)
from repro_torch.config.base import RippleConfig  # noqa: E402
from repro_torch.core.reuse import compute_reuse  # noqa: E402
from repro_torch.core.schedule import threshold_for_step  # noqa: E402
from repro_torch.kernels.reuse_mask.ops import (  # noqa: E402
    fused_compute_reuse, fused_reuse_eligible, fused_reuse_snap)

torch.set_num_threads(2)

THETAS = {"t": 0.2, "x": 0.25, "y": 0.3}


def _correlated(seed, shape, grid, noise=0.25):
    """Smooth grid tokens: neighbours along t, x and y differ by small
    steps, so a θ of 0.2–0.3 snaps a sizeable fraction of every axis."""
    B, H, N, d = shape
    T, Hh, W = grid
    rng = np.random.default_rng(seed)
    steps = noise * rng.standard_normal((B, H, T, Hh, W, d))
    x = rng.standard_normal((B, H, 1, 1, 1, d)) \
        + steps.cumsum(2).cumsum(3).cumsum(4)
    return x.reshape(B, H, N, d).astype(np.float32)


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.uint32)


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("grid", [(4, 4, 4), (1, 4, 4), (3, 5, 7)])
@pytest.mark.parametrize("granularity", ["channel", "token", "group"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_reuse_bit_equal_to_jax(grid, granularity, dtype):
    N = grid[0] * grid[1] * grid[2]
    x = _correlated(sum(grid), (1, 2, N, 64), grid)
    def j_reuse(xj, th):
        r = j_compute_reuse(xj, grid, th, granularity=granularity)
        return r.snapped, r.mask, r.axis_masks

    if dtype == "float32":
        # Compiled once instead of op by op: faster, same f32 roundings.
        # bf16 stays eager: under jit XLA may keep the Δ chain's bf16
        # intermediates in f32 (excess precision), while the per-op
        # rounding of the eager path is the contract the fused kernel
        # (Pallas and CUDA) repeats.
        j_reuse = jax.jit(j_reuse)
    s_j, m_j, axm_j = j_reuse(_jax(x, dtype),
                              {a: jnp.float32(v) for a, v in THETAS.items()})
    r_t = compute_reuse(_torch(x, dtype), grid, THETAS,
                        granularity=granularity)
    assert 0.05 < float(np.mean(np.asarray(m_j))) < 0.95
    np.testing.assert_array_equal(r_t.mask.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(
        _bits(r_t.snapped.float().numpy()),
        _bits(np.asarray(s_j.astype(jnp.float32))))
    for a in THETAS:
        np.testing.assert_array_equal(r_t.axis_masks[a].numpy(),
                                      np.asarray(axm_j[a]))


@pytest.mark.parametrize("grid", [(4, 4, 4), (1, 4, 4), (2, 6, 4)])
@pytest.mark.parametrize("granularity", ["channel", "token"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_wrapper_bit_equal_to_jax_interpret(grid, granularity, dtype):
    """The port's fused wrapper on CPU tensors (its plain version) against
    the JAX fused Pallas kernel in interpret mode."""
    N = grid[0] * grid[1] * grid[2]
    x = _correlated(7 + N, (2, 1, N, 32), grid)
    s_j, m_j = j_fused_compute_reuse(
        _jax(x, dtype), grid, {a: jnp.float32(v) for a, v in THETAS.items()},
        granularity=granularity, interpret=True)
    s_t, m_t = fused_compute_reuse(_torch(x, dtype), grid, THETAS,
                                   granularity=granularity)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(
        _bits(s_t.float().numpy()), _bits(np.asarray(s_j.astype(jnp.float32))))


@pytest.mark.parametrize("grid,axes,granularity", [
    ((4, 4, 4), ("t", "x", "y"), "channel"),
    ((3, 4, 4), ("t", "x", "y"), "channel"),
    ((3, 4, 4), ("x", "y"), "token"),
    ((1, 4, 4), ("t", "x", "y"), "token"),
    ((4, 5, 4), ("t", "x", "y"), "channel"),
    ((4, 4, 4), ("t", "x", "y"), "group"),
])
def test_eligibility_matches_jax(grid, axes, granularity):
    assert fused_reuse_eligible(grid, granularity=granularity, axes=axes) \
        == j_eligible(grid, granularity=granularity, axes=axes)


@pytest.mark.parametrize("total", [1, 2, 12, 28, 50])
def test_threshold_schedule_bit_equal(total):
    for kw in ({}, {"fixed_threshold": 0.3}, {"i_min": 2, "i_max": 9}):
        j_cfg = JRippleConfig(enabled=True, **kw)
        t_cfg = RippleConfig(enabled=True, **kw)
        for step in range(total):
            want = np.float32(j_threshold(j_cfg, step, total))
            assert np.float32(threshold_for_step(t_cfg, step, total)) == want


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    """No silent fallback: only CPU tensors take the plain version."""
    x = torch.empty((1, 1, 64, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_reuse_snap(x, (0.2, 0.2, 0.2), grid=(4, 4, 4))

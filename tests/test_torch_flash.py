"""Parity of the port's dense flash attention wrapper (its plain version
on CPU tensors) with the JAX Pallas kernel in interpret mode, at the
reference test's own bar, and with the JAX oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash.ref import attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash.ref import attention_ref  # noqa: E402

torch.set_num_threads(2)

# The shapes of tests/test_kernels.py::TestFlashKernel (d != dv and
# Nq != Nk, unaligned in both).
SHAPES = [(1, 1, 128, 128, 64, 64), (2, 3, 256, 256, 32, 32),
          (1, 2, 200, 333, 16, 48), (1, 1, 64, 512, 128, 128)]


def _tol(dtype):
    # tests/test_kernels.py:30, the reference kernel's own bar
    return 2e-2 if dtype == "bfloat16" else 3e-5


def _qkv(B, H, Nq, Nk, d, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Nq, d)).astype(np.float32),
            rng.standard_normal((B, H, Nk, d)).astype(np.float32),
            rng.standard_normal((B, H, Nk, dv)).astype(np.float32))


@pytest.mark.parametrize("B,H,Nq,Nk,d,dv", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_kernel(B, H, Nq, Nk, d, dv, dtype):
    q, k, v = _qkv(B, H, Nq, Nk, d, dv, Nq + Nk + d)
    out = flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                            for a in (q, k, v)))
    j_out = j_flash(*(jnp.asarray(a).astype(getattr(jnp, dtype))
                      for a in (q, k, v)), block_q=128, block_k=128)
    assert out.dtype == getattr(torch, dtype)
    assert out.shape == (B, H, Nq, dv)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               atol=_tol(dtype), rtol=1e-2)


@pytest.mark.parametrize("B,H,Nq,Nk,d,dv", SHAPES)
def test_f32_matches_jax_oracle(B, H, Nq, Nk, d, dv):
    q, k, v = _qkv(B, H, Nq, Nk, d, dv, 7 + d)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = np.asarray(j_ref(*(jnp.asarray(a) for a in (q, k, v))))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6, rtol=0)


def test_bf16_plain_version_rounds_as_jax_oracle():
    """bf16 logits and probabilities round where JAX rounds them: a few
    bf16 ulps of outputs below 4."""
    q, k, v = _qkv(1, 2, 96, 80, 32, 40, 3)
    out = attention_ref(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    want = j_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=4 * 2.0 ** -8 * 4)


def test_extreme_logits_stay_finite():
    rng = np.random.default_rng(0)
    q, k = (30.0 * rng.standard_normal((1, 1, 128, 32)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, 1, 128, 32)).astype(np.float32)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert torch.isfinite(out).all()


def test_wrapper_on_cpu_never_counts_a_launch():
    flash_ops.launches = 0
    q = torch.randn(1, 1, 16, 8)
    flash_attention(q, q, q)
    assert flash_ops.launches == 0


def test_raises_off_cpu_and_cuda():
    q = torch.randn(1, 1, 16, 8, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        flash_attention(q, q, q)

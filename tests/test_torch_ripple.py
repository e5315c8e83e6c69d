"""Parity of the port's pair-collapse attention wrapper (its plain version
on CPU tensors) with the JAX Pallas kernel in interpret mode and with the
JAX oracle, on constructed snapped operands."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ripple.ops import ripple_attention_pallas  # noqa: E402
from repro.kernels.ripple.ref import block_flags as j_block_flags  # noqa: E402
from repro.kernels.ripple.ref import ripple_attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.ripple.ops import (  # noqa: E402
    attention_scale, ripple_attention, ripple_tile_stats)
from repro_torch.kernels.ripple.ref import block_flags  # noqa: E402

torch.set_num_threads(2)


def _snapped_operand(seed, B, H, N, d, frac):
    """Like tests/test_kernels.py: each pair's follower copies its
    representative with probability ``frac``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, N, d)).astype(np.float32)
    coll = rng.uniform(size=(B, H, N // 2, 1)) < frac
    e, o = x[..., 0::2, :], x[..., 1::2, :]
    return np.stack([e, np.where(coll, e, o)], 3).reshape(B, H, N, d)


# f32 on CPU: both sides compute dense softmax in f32; only summation
# order differs.
_TOL = 3e-5


@pytest.mark.parametrize("N,d,frac", [
    (256, 32, 0.0), (256, 32, 0.6), (256, 32, 1.0), (130, 16, 1.0),
    (130, 16, 0.6),
])
def test_matches_jax_kernel_and_oracle(N, d, frac):
    q = _snapped_operand(1, 1, 2, N, d, frac)
    k = _snapped_operand(2, 1, 2, N, d, frac)
    v = np.random.default_rng(3).standard_normal((1, 2, N, d)).astype(
        np.float32)
    out = ripple_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v)).numpy()
    j_kernel = ripple_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), block_q=64,
                                       block_k=64, interpret=True)
    j_oracle = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out, np.asarray(j_kernel), atol=_TOL)
    np.testing.assert_allclose(out, np.asarray(j_oracle), atol=_TOL)


def test_bf16_matches_jax_oracle():
    """bf16: both round logits and probabilities to bf16 between the
    products, so the tolerance is a few bf16 ulps of outputs below 1."""
    q = _snapped_operand(4, 1, 2, 256, 64, 0.6)
    k = _snapped_operand(5, 1, 2, 256, 64, 0.6)
    v = np.random.default_rng(6).standard_normal((1, 2, 256, 64)).astype(
        np.float32)
    out = ripple_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                             for a in (q, k, v))).float().numpy()
    ref = j_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                scale=attention_scale(64))
    np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2)


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_block_flags_match_jax(frac):
    x = _snapped_operand(8, 1, 3, 512, 16, frac).reshape(3, 512, 16)
    want = j_block_flags(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]), 32)
    np.testing.assert_array_equal(block_flags(torch.from_numpy(x), 32).numpy(),
                                  np.asarray(want))


def test_partial_last_tile_counts_only_real_pairs():
    x = torch.from_numpy(_snapped_operand(9, 1, 1, 130, 8, 1.0)).reshape(
        1, 130, 8)
    assert block_flags(x, 32).tolist() == [[1, 1, 1]]
    x[0, 129, 0] += 1.0  # break the last real pair
    assert block_flags(x, 32).tolist() == [[1, 1, 0]]


def test_tile_stats_count_collapsed_work():
    q = torch.from_numpy(_snapped_operand(10, 1, 1, 128, 8, 1.0))
    qf, kf, flops = ripple_tile_stats(q, q, 8)
    assert (qf, kf) == (1.0, 1.0)
    assert flops == 2.0 * 64 * 64 * 16  # one quarter of dense: 2·128²·16
    dense = torch.from_numpy(_snapped_operand(11, 1, 1, 128, 8, 0.0))
    assert ripple_tile_stats(dense, dense, 8)[2] == 2.0 * 128 * 128 * 16


def test_scale_is_the_float32_value_jax_uses():
    want = np.float32(1.0) / np.sqrt(np.float32(128))
    assert np.float32(attention_scale(128)) == want
    assert float(np.asarray(1.0 / jnp.sqrt(jnp.asarray(128, jnp.float32)))) \
        == attention_scale(128)


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    x = torch.empty((1, 1, 64, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ripple_attention(x, x, x)

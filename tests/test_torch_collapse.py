"""Parity of the port's pair-collapse modules with the JAX package:
``core/collapse.py`` (permutations and flags bit-equal, the collapsed
attention at an f32 tolerance), the ``collapse`` dispatch backend,
``compute_reuse(protect_axis=...)`` (bit-equal), the collapse savings
and the reference's 128-pair block statistic."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.config.base import RippleConfig as JRippleConfig  # noqa: E402
from repro.core import savings as j_savings  # noqa: E402
from repro.core.collapse import (  # noqa: E402
    collapsed_attention as j_collapsed_attention,
    pair_flags as j_pair_flags, pair_major_order as j_pair_major_order)
from repro.core.dispatch import attention_dispatch as j_dispatch  # noqa: E402
from repro.core.reuse import compute_reuse as j_compute_reuse  # noqa: E402
from repro.kernels.ripple.ops import (  # noqa: E402
    ripple_block_stats as j_ripple_block_stats)
from repro_torch.config.base import RippleConfig  # noqa: E402
from repro_torch.core import savings  # noqa: E402
from repro_torch.core.collapse import (  # noqa: E402
    collapsed_attention, pair_flags, pair_major_order)
from repro_torch.core.dispatch import attention_dispatch  # noqa: E402
from repro_torch.core.reuse import compute_reuse  # noqa: E402
from repro_torch.kernels.ripple.ops import ripple_block_stats  # noqa: E402

torch.set_num_threads(2)

# f32 on CPU: the same exp / sum / divide sequence on both sides; only
# the summation order of the products and sums differs, on O(1) values.
_TOL = 2e-5


def _snapped(seed, shape, frac):
    """Each pair's follower copies its representative with probability
    ``frac`` (a ragged last token when N is odd stays free)."""
    rng = np.random.default_rng(seed)
    *lead, N, d = shape
    x = rng.standard_normal(shape).astype(np.float32)
    n = N // 2
    coll = rng.uniform(size=(*lead, n, 1)) < frac
    head = x[..., : 2 * n, :].reshape(*lead, n, 2, d)
    head[..., 1, :] = np.where(coll, head[..., 0, :], head[..., 1, :])
    x[..., : 2 * n, :] = head.reshape(*lead, 2 * n, d)
    return x


def _correlated(seed, shape, grid, noise=0.25):
    B, H, N, d = shape
    T, Hh, W = grid
    rng = np.random.default_rng(seed)
    steps = noise * rng.standard_normal((B, H, T, Hh, W, d))
    x = rng.standard_normal((B, H, 1, 1, 1, d)) \
        + steps.cumsum(2).cumsum(3).cumsum(4)
    return x.reshape(B, H, N, d).astype(np.float32)


@pytest.mark.parametrize("grid", [(4, 6, 8), (5, 7, 3), (1, 4, 4)])
@pytest.mark.parametrize("axis", ["t", "y", "x"])
def test_pair_major_order_bit_equal(grid, axis):
    perm = pair_major_order(grid, axis)
    np.testing.assert_array_equal(perm, j_pair_major_order(grid, axis))
    assert sorted(perm.tolist()) == list(range(int(np.prod(grid))))


@pytest.mark.parametrize("N", [64, 65])
def test_pair_flags_bit_equal(N):
    x = _snapped(0, (2, 3, N, 16), 0.5)
    got = pair_flags(torch.from_numpy(x)).numpy()
    want = np.asarray(j_pair_flags(jnp.asarray(x)))
    assert 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("Nq,Nk", [(64, 64), (65, 63), (31, 48)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_collapsed_attention_matches_jax(Nq, Nk, with_bias):
    """Both collapse sides, a ragged tail on either side, an optional
    window-constant bias."""
    q = _snapped(1, (1, 2, Nq, 32), 0.6)
    k = _snapped(2, (1, 2, Nk, 32), 0.6)
    v = np.random.default_rng(3).standard_normal((1, 2, Nk, 24)).astype(
        np.float32)
    bias = None
    if with_bias:
        rng = np.random.default_rng(4)
        pair_bias = rng.standard_normal((1, 2, Nq, (Nk + 1) // 2))
        bias = np.repeat(pair_bias, 2, axis=-1)[..., :Nk].astype(np.float32)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(32)))
    got = collapsed_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=scale,
        bias=None if bias is None else torch.from_numpy(bias)).numpy()
    want = np.asarray(j_collapsed_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        bias=None if bias is None else jnp.asarray(bias)))
    np.testing.assert_allclose(got, want, atol=_TOL, rtol=_TOL)
    # the default scale is the reference's too
    got = collapsed_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v)).numpy()
    want = np.asarray(j_collapsed_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v)))
    np.testing.assert_allclose(got, want, atol=_TOL, rtol=_TOL)


@pytest.mark.parametrize("how", ["backend", "execution"])
def test_collapse_backend_matches_jax(how):
    """The repaired fault: ``backend='collapse'`` (or the 'collapse'
    execution under 'auto' on the CPU) answered with an exception in the
    port and with the collapsed attention in JAX."""
    grid = (4, 4, 4)
    shape = (1, 2, 64, 32)
    q = _correlated(5, shape, grid)
    k = _correlated(6, shape, grid)
    v = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    thetas = {"t": 0.2, "x": 0.25, "y": 0.3}
    kw = ({"backend": "collapse"} if how == "backend" else {})
    cfg_kw = {} if how == "backend" else {"execution": "collapse"}
    got = attention_dispatch(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        grid=grid, cfg=RippleConfig(enabled=True, **cfg_kw), thetas=thetas,
        **kw).numpy()
    want = np.asarray(j_dispatch(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), grid=grid,
        cfg=JRippleConfig(enabled=True, **cfg_kw),
        thetas={a: jnp.float32(t) for a, t in thetas.items()}, **kw))
    np.testing.assert_allclose(got, want, atol=_TOL, rtol=_TOL)
    # the call snapped something: not the dense answer
    dense = attention_dispatch(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        grid=grid, cfg=RippleConfig(enabled=True), thetas=thetas,
        backend="dense").numpy()
    assert np.abs(got - dense).max() > 1e-3


@pytest.mark.parametrize("protect_axis", ["t", "y", "x"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_reuse_protect_axis_bit_equal(protect_axis, dtype):
    grid = (4, 6, 4)
    x = _correlated(8, (1, 2, 96, 32), grid)
    thetas = {"t": 0.3, "x": 0.35, "y": 0.4}
    r_j = j_compute_reuse(jnp.asarray(x).astype(getattr(jnp, dtype)), grid,
                          {a: jnp.float32(t) for a, t in thetas.items()},
                          protect_axis=protect_axis)
    r_t = compute_reuse(torch.from_numpy(x).to(getattr(torch, dtype)), grid,
                        thetas, protect_axis=protect_axis)
    np.testing.assert_array_equal(r_t.mask.numpy(), np.asarray(r_j.mask))
    np.testing.assert_array_equal(
        r_t.snapped.float().numpy().view(np.uint32),
        np.asarray(r_j.snapped.astype(jnp.float32)).view(np.uint32))
    for a in thetas:
        np.testing.assert_array_equal(r_t.axis_masks[a].numpy(),
                                      np.asarray(r_j.axis_masks[a]))
    # protection changed something, and the other axes never snap a
    # representative along the protected axis (every length here is even)
    plain = compute_reuse(torch.from_numpy(x).to(getattr(torch, dtype)),
                          grid, thetas)
    assert not torch.equal(plain.mask, r_t.mask)
    T, H, W = grid
    tok = np.arange(T * H * W)
    pos = {"t": tok // (H * W), "y": tok // W % H, "x": tok % W}
    rep = pos[protect_axis] % 2 == 0
    for a in thetas:
        if a != protect_axis:
            assert not r_t.axis_masks[a].numpy()[..., rep, :].any()


@pytest.mark.parametrize("frac", [0.3, 0.9])
def test_collapse_savings_equal_to_jax(frac):
    # token-wise snaps (whole tokens, so whole pairs collapse), a few
    # channels knocked out; Q masks only followers, K masks anything
    rng = np.random.default_rng(9)
    tok = rng.uniform(size=(2, 2, 2, 64, 1)) < frac
    hole = rng.uniform(size=(2, 2, 2, 64, 16)) < 0.01
    m = np.broadcast_to(tok, hole.shape) & ~hole
    qm = m[0] & (np.arange(64)[:, None] % 2 == 1)
    km = m[1]
    pq, pk = savings.pair_collapse_fractions(torch.from_numpy(qm),
                                             torch.from_numpy(km))
    jq, jk = j_savings.pair_collapse_fractions(jnp.asarray(qm),
                                               jnp.asarray(km))
    assert float(pq) == float(jq) and float(pk) == float(jk)
    assert 0 < float(pq) < 1 and 0 <= float(pk) < 1
    assert float(savings.collapse_savings(torch.from_numpy(qm),
                                          torch.from_numpy(km))) \
        == pytest.approx(float(j_savings.collapse_savings(jnp.asarray(qm),
                                                          jnp.asarray(km))),
                         abs=1e-7)
    assert savings.attention_flops(100, 60, 32, 24, 3, 2) \
        == j_savings.attention_flops(100, 60, 32, 24, 3, 2)
    assert savings.theoretical_speedup(0.78, 0.5) \
        == pytest.approx(float(j_savings.theoretical_speedup(0.78, 0.5)))


@pytest.mark.parametrize("N,block,frac", [(512, 128, 0.95), (600, 128, 1.0),
                                          (200, 64, 0.5)])
def test_ripple_block_stats_equal_to_jax(N, block, frac):
    # whole blocks collapse with probability frac
    rng = np.random.default_rng(N)
    x = rng.standard_normal((2, 2, N, 16)).astype(np.float32)
    P = N // 2
    blk = rng.uniform(size=(2, 2, -(-P // block), 1)) < frac
    coll = np.repeat(blk, block, axis=2)[:, :, :P]
    e, o = x[..., 0::2, :], x[..., 1::2, :]
    x = np.stack([e, np.where(coll, e, o)], 3).reshape(x.shape)
    k = np.roll(x, 2, axis=2)
    got = float(ripple_block_stats(torch.from_numpy(x), torch.from_numpy(k),
                                   block_q=block, block_k=block))
    want = float(j_ripple_block_stats(jnp.asarray(x), jnp.asarray(k),
                                      block_q=block, block_k=block))
    assert got == pytest.approx(want, abs=1e-7)

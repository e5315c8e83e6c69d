"""Parity of the port's block-sparse attention wrapper (its plain version
on CPU tensors) with the JAX Pallas kernel in interpret mode and with the
JAX oracle, and bit-equality of the block-map helpers, on inputs made
with numpy from a seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.sparse import ops as j_ops  # noqa: E402
from repro.kernels.sparse import ref as j_ref  # noqa: E402
from repro_torch.kernels.sparse import ops  # noqa: E402
from repro_torch.kernels.sparse import ref  # noqa: E402
from repro_torch.kernels.sparse.ops import (  # noqa: E402
    FULL, PARTIAL, SKIP, block_map_from_keep, sparse_attention,
    sparse_block_stats)

torch.set_num_threads(2)


def _qkv(seed, N, d=32, H=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, H, N, d)).astype(dtype)
                 for _ in range(3))


def _keep(seed, N, density, H=2):
    return np.random.default_rng(seed).uniform(size=(1, H, N, N)) < density


def _bias_of(keep):
    return np.where(keep, 0.0, -np.inf).astype(np.float32)


def _case(name, N):
    """(keep or None, bias or None, block_map or None, block) per case."""
    blk = 64
    nb = -(-N // blk)
    if name == "all_full":
        return None, None, np.full((nb, nb), FULL, np.int32), blk
    if name == "all_skip":
        return None, None, np.full((nb, nb), SKIP, np.int32), blk
    if name == "no_map_no_bias":
        return None, None, None, blk
    if name == "random_bias_partial":
        bias = np.random.default_rng(5).standard_normal(
            (1, 2, N, N)).astype(np.float32)
        return None, bias, np.full((nb, nb), PARTIAL, np.int32), blk
    keep = _keep(3, N, 0.5)
    keep[..., :64, :64] = True       # a FULL tile
    keep[..., 64:128, :64] = False   # a SKIP tile
    if name == "row_skipped":
        keep[..., 128:192, :] = False  # every tile of a query row skipped
    if name == "clamped":
        blk = 128                      # clamps to the N < 128 token count
    bias = _bias_of(keep)
    if name == "no_map_bias":
        return keep, bias, None, blk
    return keep, bias, np.asarray(
        j_ops.block_map_from_keep(jnp.asarray(keep), blk, blk)), blk


CASES = [("all_full", 256), ("all_skip", 256), ("mixed", 256),
         ("row_skipped", 256), ("mixed", 130), ("mixed", 200),
         ("random_bias_partial", 256), ("no_map_bias", 256),
         ("no_map_no_bias", 256), ("clamped", 100)]


def _port(q, k, v, bias, bmap, blk, dtype=torch.float32):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return sparse_attention(t(q).to(dtype), t(k).to(dtype), t(v).to(dtype),
                            bias=t(bias), block_map=t(bmap), block_q=blk,
                            block_k=blk)


# f32 on CPU: both sides compute softmax attention in f32; the JAX kernel
# sums online over tiles, the oracles at once, so only summation order
# differs (outputs are O(1)).
_TOL = 1e-5


@pytest.mark.parametrize("name,N", CASES, ids=[f"{c}-{n}" for c, n in CASES])
def test_matches_jax_kernel_and_oracle(name, N):
    q, k, v = _qkv(1, N)
    keep, bias, bmap, blk = _case(name, N)
    out = _port(q, k, v, bias, bmap, blk).numpy()
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    j_kernel = np.asarray(j_ops.sparse_attention_pallas(
        j(q), j(k), j(v), bias=j(bias), block_map=j(bmap), block_q=blk,
        block_k=blk, interpret=True))
    j_oracle = np.asarray(j_ref.sparse_attention_ref(
        j(q), j(k), j(v), bias=j(bias), block_map=j(bmap), block_q=blk,
        block_k=blk))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, j_kernel, atol=_TOL, rtol=0)
    np.testing.assert_allclose(out, j_oracle, atol=_TOL, rtol=0)
    if name == "all_skip":
        assert not out.any()
    if name == "row_skipped":
        assert not out[..., 128:192, :].any()
        assert np.abs(out[..., :128, :]).min(axis=-1).max() > 0


@pytest.mark.parametrize("d", [40, 80, 160, 256])
@pytest.mark.parametrize("name", ["mixed", "random_bias_partial"])
def test_head_dims_above_128_match_jax_kernel(d, name):
    """unet-sd15's head dims (40, 80, 160) and the largest the kernel
    takes (256): the plain version against the JAX kernel in interpret
    mode, f32, on a mixed map under a -inf bias and on an all-PARTIAL
    map under a finite one."""
    q, k, v = _qkv(11, 130, d=d)
    _, bias, bmap, blk = _case(name, 130)
    out = _port(q, k, v, bias, bmap, blk).numpy()
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = np.asarray(j_ops.sparse_attention_pallas(
        j(q), j(k), j(v), bias=j(bias), block_map=j(bmap), block_q=blk,
        block_k=blk, interpret=True))
    np.testing.assert_allclose(out, want, atol=_TOL, rtol=0)


def test_wrapper_refuses_head_dims_above_256():
    """The kernel takes head dims up to 256 on both paths; the wrapper
    refuses a larger one before it builds or launches anything."""
    assert ops._MAX_DIM == 256
    big = torch.zeros((1, 1, 64, 257))
    with pytest.raises(ValueError, match="head dims <= 256"):
        ops._launch(big, big, big, None, None, 64, 64)
    v = torch.zeros((1, 1, 64, 257))
    q = torch.zeros((1, 1, 64, 256))
    with pytest.raises(ValueError, match="head dims <= 256"):
        ops._launch(q, q, v, None, None, 64, 64)


def test_bf16_matches_jax_oracle():
    """bf16 operands: both round the product's logits to bf16 and the
    output to bf16, so the gap is one bf16 ulp of outputs below 2 plus
    the f32 summation order: 2^-7 absolute."""
    q, k, v = _qkv(7, 256)
    keep, bias, bmap, blk = _case("mixed", 256)
    out = _port(q, k, v, bias, bmap, blk, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    want = j_ref.sparse_attention_ref(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), bias=jnp.asarray(bias),
        block_map=jnp.asarray(bmap), block_q=blk, block_k=blk)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2.0 ** -7, rtol=0)


@pytest.mark.parametrize("n_q,n_k,bq,bk", [
    (256, 256, 128, 128), (100, 300, 128, 128), (8448, 8448, 128, 128),
    (1, 5, 64, 64), (130, 200, 64, 32)])
def test_sparse_grid_matches_jax(n_q, n_k, bq, bk):
    assert ref.sparse_grid(n_q, n_k, bq, bk) == \
        j_ref.sparse_grid(n_q, n_k, bq, bk)


@pytest.mark.parametrize("shape,blk,density", [
    ((1, 2, 256, 256), 64, 0.5), ((2, 1, 130, 200), 64, 0.97),
    ((1, 1, 100, 100), 128, 0.3), ((3, 77, 50), 32, 0.02),
    ((1, 2, 200, 130), 64, 0.0)])
def test_block_maps_bit_equal_to_jax(shape, blk, density):
    """Tiling (ragged edges padded with the edge value), expansion back
    to tokens, and the skipped-tile fraction."""
    keep = np.random.default_rng(sum(shape)).uniform(size=shape) < density
    keep[..., :blk, :blk] = True
    want = np.asarray(j_ops.block_map_from_keep(jnp.asarray(keep), blk, blk))
    got = block_map_from_keep(torch.from_numpy(keep), blk, blk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    n_q, n_k = shape[-2:]
    np.testing.assert_array_equal(
        ref.expand_block_map(got, n_q, n_k, blk, blk).numpy(),
        np.asarray(j_ref.expand_block_map(jnp.asarray(want), n_q, n_k, blk,
                                          blk)))
    assert sparse_block_stats(got).item() == \
        float(j_ops.sparse_block_stats(jnp.asarray(want)))


def test_edge_padding_never_makes_partial():
    """A ragged all-keep (or keep-nothing) edge stays FULL (SKIP)."""
    for value, state in ((True, FULL), (False, SKIP)):
        keep = torch.full((1, 1, 130, 130), value)
        assert (block_map_from_keep(keep, 64, 64) == state).all()


def test_carry_and_return_state_raise():
    """The carry is a (m, l, acc) triple of the operands' state shapes:
    a malformed one raises on every path instead of running (CPU here,
    the kernel wrapper's own check for CUDA tensors)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 64))
    good = ref.fresh_state((1, 2), 64, 32)
    with pytest.raises(ValueError, match="carry"):
        sparse_attention(q, k, v, carry=(good[0], good[1], good[2][..., :8]))
    with pytest.raises(ValueError, match="carry"):
        ops._check_state(good[:2], 1, 2, 64, 32, q.device)
    with pytest.raises(ValueError, match="carry m must have shape"):
        ops._check_state((good[1][..., :8],) + good[1:], 1, 2, 64, 32,
                         q.device)
    out, state = sparse_attention(q, k, v, carry=good, return_state=True)
    assert torch.equal(out, sparse_attention(q, k, v))
    assert [tuple(t.shape) for t in state] == \
        [(1, 2, 64), (1, 2, 64), (1, 2, 64, 32)]


def test_raises_off_cpu_and_cuda():
    q = torch.empty((1, 1, 64, 32), device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        sparse_attention(q, q, q)


def test_wrapper_on_cpu_never_counts_a_launch():
    before = ops.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 64))
    sparse_attention(q, k, v)
    assert ops.launches == before


def test_reset_clears_counts_by_shape_and_cpu_calls_add_none():
    from repro_torch.kernels import reset_launch_counts

    ops.launches_by_shape[(64, 40)] = 3
    reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, d=40))
    sparse_attention(q, k, v)
    assert ops.launches == 0 and ops.launches_by_shape == {}

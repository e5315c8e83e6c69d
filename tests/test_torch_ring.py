"""Parity of the port's context-parallel ring (``core/ring.py``, DESIGN.md
§14) and of the sparse kernel's carry with the JAX package.

The carry: the plain version chained over aligned key slices equals one
full-width call bit for bit, its ``(out, (m, l, acc))`` matches
``sparse_attention_pallas(..., carry=, return_state=True)`` in interpret
mode, and a fully masked row gives zeros.  The ring runs on 2 and 4 CPU
shards (``REPRO_TORCH_FORCE_DEVICE_COUNT``, one thread a shard) over the
JAX ring tests' grids and windows: bit for bit the unsharded dispatch
for the snap policies, within 1e-5 relative for svg; the decision cache
replays and refreshes per shard; elided hops equal the all-SKIP hop
slices of the unsharded block map; and a subprocess runs the JAX ring on
8 virtual CPU devices to hold the port's outputs and elided count to it.
Inputs are made with numpy from a seed."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import RippleConfig as JRippleConfig  # noqa: E402
from repro.core import dispatch as j_dispatch  # noqa: E402
from repro.kernels.sparse.ops import sparse_attention_pallas  # noqa: E402
from repro_torch.config.base import RippleConfig  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.dispatch import (attention_dispatch,  # noqa: E402
                                       dispatch_mesh, resolve_plan)
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels.sparse.ops import (SKIP,  # noqa: E402
                                            block_map_from_keep,
                                            sparse_attention)
from repro_torch.launch.mesh import (FORCE_DEVICE_COUNT_ENV,  # noqa: E402
                                     parse_mesh_spec)

torch.set_num_threads(2)

# The JAX ring tests' grid/window pairs: (4, 4, 4) at 4 ways puts a
# window across a whole shard (one frame a shard, the multi-hop halo),
# (8, 4, 4) has a window-misaligned shard boundary, (8, 8, 8) divides
# evenly at every way count.
GRIDS = [(4, 4, 4), (8, 4, 4), (8, 8, 8)]
WINDOWS = (2, 3, 2)
# Snap policies ring on the reference backend (the bitwise contract);
# svg and static take the sparse backend.
BACKENDS = {"ripple": "reference", "equal_mse": "reference", "svg": None,
            "static": None, "dense": None}
STEP, TOTAL = 3, 6  # step 3 of 6 snaps under i_min 2, i_max 6


def _cfg(window=2, **kw):
    return RippleConfig(enabled=True, theta_min=0.2, theta_max=0.5,
                        i_min=2, i_max=6, window=window, **kw)


def _jcfg(window=2, **kw):
    return JRippleConfig(enabled=True, theta_min=0.2, theta_max=0.5,
                         i_min=2, i_max=6, window=window, **kw)


def _qkv(seed, n, d=16, lead=(2, 2)):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(lead + (n, d)).astype(np.float32)
                 for _ in range(3))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def shards(monkeypatch):
    """Up to 8 CPU mesh shards for the test."""
    monkeypatch.setenv(FORCE_DEVICE_COUNT_ENV, "8")
    dispatch._PLAN_CACHE.clear()
    yield
    dispatch._PLAN_CACHE.clear()


def _seq_mesh(s):
    return parse_mesh_spec(f"1x1x{s}", device="cpu")


# ---------------------------------------------------------------------------
# The carry
# ---------------------------------------------------------------------------


def _carry_case(name, n=256, blk=64):
    """(bias or None, block map or None) of a carry case."""
    rng = np.random.default_rng(3)
    if name == "all_full":
        return None, None
    if name == "random_bias_partial":
        nb = n // blk
        return (rng.standard_normal((1, 2, n, n)).astype(np.float32),
                np.full((nb, nb), 2, np.int32))
    keep = rng.uniform(size=(1, 2, n, n)) < 0.5
    keep[..., :64, :64] = True        # a FULL tile
    keep[..., 64:128, :64] = False    # a SKIP tile
    keep[..., 128:192, :] = False     # a row whose every tile is skipped
    bmap = block_map_from_keep(torch.from_numpy(keep), blk, blk).numpy()
    return np.where(keep, 0.0, -np.inf).astype(np.float32), bmap


def _chain(q, k, v, bias, bmap, cuts, blk=64):
    """The plain version chained over key slices [cuts[i], cuts[i+1])."""
    state = out = None
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        out, state = sparse_attention(
            q, k[..., lo:hi, :], v[..., lo:hi, :],
            bias=None if bias is None else bias[..., lo:hi],
            block_map=None if bmap is None else bmap[..., lo // blk:hi // blk],
            block_q=blk, block_k=blk, carry=state, return_state=True)
    return out, state


@pytest.mark.parametrize("name", ["all_full", "mixed", "random_bias_partial"])
@pytest.mark.parametrize("cuts", [(0, 128, 256), (0, 64, 192, 256),
                                  (0, 64, 128, 192, 256)])
def test_hop_chain_equals_full_width_call(name, cuts):
    """Chained over aligned key slices through the (m, l, acc) carry, the
    plain version equals one full-width call bit for bit: every key tile
    is the same computation either way (tests/test_ring_attention.py's
    contract)."""
    q, k, v = (_t(a) for a in _qkv(7, 256, d=32, lead=(1, 2)))
    bias, bmap = _carry_case(name)
    bias = None if bias is None else _t(bias)
    bmap = None if bmap is None else _t(bmap)
    full, full_state = sparse_attention(q, k, v, bias=bias, block_map=bmap,
                                        block_q=64, block_k=64,
                                        return_state=True)
    assert torch.equal(full, sparse_attention(q, k, v, bias=bias,
                                              block_map=bmap, block_q=64,
                                              block_k=64))
    out, state = _chain(q, k, v, bias, bmap, cuts)
    assert torch.equal(out, full)
    for a, b in zip(state, full_state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["all_full", "mixed", "random_bias_partial"])
def test_state_matches_jax_carry(name):
    """Two hops through the port's carry against two hops through the JAX
    kernel's (interpret mode): out and (m, l, acc) at the tolerance
    tests/test_torch_sparse.py holds the plain version to (f32, only the
    summation order differs)."""
    q, k, v = _qkv(8, 256, d=32, lead=(1, 2))
    bias, bmap = _carry_case(name)
    got_out, got = _chain(_t(q), _t(k), _t(v),
                          None if bias is None else _t(bias),
                          None if bmap is None else _t(bmap), (0, 128, 256))
    state = None
    for lo, hi in ((0, 128), (128, 256)):
        want_out, state = sparse_attention_pallas(
            jnp.asarray(q), jnp.asarray(k[..., lo:hi, :]),
            jnp.asarray(v[..., lo:hi, :]),
            bias=None if bias is None else jnp.asarray(bias[..., lo:hi]),
            block_map=None if bmap is None
            else jnp.asarray(bmap[..., lo // 64:hi // 64]),
            block_q=64, block_k=64, carry=state, return_state=True,
            interpret=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=0)
    for g, w in zip(got, state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-6)


def test_fully_masked_query_row_is_zeros_not_nan():
    """A row whose bias is -inf everywhere keeps l = 0; both the call's
    output and the ring's ``acc / where(l > 0, l, 1)`` are zeros."""
    from repro_torch.kernels.sparse.ref import finalize

    q, k, v = (_t(a) for a in _qkv(5, 8, d=4, lead=(1, 1)))
    keep = torch.ones((8, 8), dtype=torch.bool)
    keep[2] = False
    bias = torch.where(keep, 0.0, float("-inf"))
    bmap = block_map_from_keep(keep, 4, 4)
    out, (m, l, acc) = sparse_attention(q, k, v, bias=bias, block_map=bmap,
                                        block_q=4, block_k=4,
                                        return_state=True)
    for arr in (out, finalize(acc, l, torch.float32)):
        assert torch.isfinite(arr).all()
        assert not arr[0, 0, 2].any()
    assert float(l[0, 0, 2]) == 0.0


# ---------------------------------------------------------------------------
# The ring against the unsharded dispatch
# ---------------------------------------------------------------------------


def _dispatch(q, k, v, grid, cfg, policy, mesh=None, **kw):
    with dispatch_mesh(mesh):
        return attention_dispatch(q, k, v, grid=grid, cfg=cfg, step=STEP,
                                  total_steps=TOTAL, policy=policy,
                                  backend=BACKENDS[policy], **kw)


@pytest.mark.parametrize("ways", [2, 4])
@pytest.mark.parametrize("grid,window", list(zip(GRIDS, WINDOWS)))
@pytest.mark.parametrize("policy", ["ripple", "equal_mse", "svg", "static",
                                    "dense"])
def test_ring_matches_unsharded(shards, policy, grid, window, ways):
    """Bit for bit for the snap policies on the reference backend; svg and
    static (the sparse ring, hop order rotating the softmax sum) within
    1e-5 relative, the reference's documented bar; dense never rings."""
    n = int(np.prod(grid))
    q, k, v = (_t(a) for a in _qkv(1, n))
    cfg = _cfg(window)
    ref = _dispatch(q, k, v, grid, cfg, policy)
    mesh = _seq_mesh(ways)
    plan = resolve_plan(q.shape, v.shape, cfg, on_cuda=False,
                        backend=BACKENDS[policy], policy=policy, mesh=mesh,
                        grid=grid)
    out = _dispatch(q, k, v, grid, cfg, policy, mesh)
    if policy == "dense":
        assert plan.seq_axis is None and not plan.sharded
        assert torch.equal(out, ref)
        return
    assert plan.seq_shards == ways and f"ring=seq{ways}" in plan.summary()
    if policy in ("ripple", "equal_mse"):
        assert torch.equal(out, ref)
    else:
        rel = float((out - ref).norm() / ref.norm())
        assert rel <= 1e-5, rel


@pytest.mark.parametrize("policy,grid,window", [
    ("ripple", (8, 4, 4), 3), ("equal_mse", (4, 4, 4), 2),
    ("svg", (8, 8, 8), 2)])
def test_ring_matches_jax_unsharded(shards, policy, grid, window):
    """The port's ring against the JAX package's unsharded dispatch
    (jitted: one compile), at the tolerance of the port's dispatch
    parity tests (f32, 1e-5)."""
    n = int(np.prod(grid))
    q, k, v = _qkv(2, n)
    want = jax.jit(lambda q, k, v: j_dispatch.attention_dispatch(
        q, k, v, grid=grid, cfg=_jcfg(window), step=jnp.asarray(STEP),
        total_steps=TOTAL, policy=policy, backend=BACKENDS[policy]))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _dispatch(_t(q), _t(k), _t(v), grid, _cfg(window), policy,
                    _seq_mesh(4 if grid[0] % 4 == 0 else 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_seq_ineligible_shapes_replicate_the_token_axis(shards):
    """The reference's fallbacks, named by the plan: a text prefix
    (grid slice), T not divisible by the seq degree, or a policy that
    does not ring (svg composed with snapping) replicate the tokens."""
    mesh = _seq_mesh(4)
    shape = (2, 2, 96, 16)
    cfg = _cfg()
    for kw in ({"grid": (6, 4, 4)},
               {"grid": (4, 4, 4), "grid_slice": (32, 64)}):
        plan = resolve_plan(shape, shape, cfg, on_cuda=False,
                            backend="reference", policy="ripple", mesh=mesh,
                            **kw)
        assert plan.seq_axis is None and "ring=" not in plan.summary()
    combo = dataclasses.replace(cfg, svg_mask=True)
    plan = resolve_plan((2, 2, 64, 16), (2, 2, 64, 16), combo, on_cuda=False,
                        policy="ripple", mesh=mesh, grid=(4, 4, 4))
    assert plan.seq_axis is None


# ---------------------------------------------------------------------------
# The decision cache on the ring
# ---------------------------------------------------------------------------


def _scan(q, k, v, grid, cfg, policy, mesh, steps):
    state, outs = None, []
    with dispatch_mesh(mesh):
        for s in range(steps):
            out, state = attention_dispatch(
                q, k, v, grid=grid, cfg=cfg, step=s, total_steps=TOTAL,
                policy=policy, backend=BACKENDS[policy],
                cached_decision=state, return_decision=True)
            outs.append(out)
    return outs, state


@pytest.mark.parametrize("policy", ["svg", "ripple"])
def test_cache_hit_replays_bitwise(shards, policy):
    """A hit step re-applies the cached plan as it is, so on the same
    inputs a hit equals a forced refresh bit for bit (the §13 replay
    contract on the ring); each shard carries its own counters."""
    grid = (8, 8, 8)
    q, k, v = (_t(a) for a in _qkv(11, 512))
    mesh = _seq_mesh(2)
    outs = {}
    for every in (2, 1):  # step 1: a hit against a forced refresh
        cfg = dataclasses.replace(_cfg(), reuse_every=every)
        got, state = _scan(q, k, v, grid, cfg, policy, mesh, 2)
        outs[every] = got[-1]
        assert tuple(state.hits.shape) == (2, 2, 2)  # (B, H, S)
        assert int(state.hits.max()) == (1 if every == 2 else 0)
        if policy == "svg":
            assert tuple(state.elided.shape) == (2,)  # one counter a shard
            assert int(state.elided.sum()) > 0
            assert (state.elided <= 2 * 2).all()  # <= steps x hops a shard
    assert torch.equal(outs[2], outs[1])


def test_one_shard_refresh_does_not_desync_others(shards):
    """A drift-forced refresh on one seq shard stays local: the other
    shard replays its cached plan bit for bit and only its hit counter
    moves (the collectives run outside the refresh choice)."""
    grid, n = (4, 4, 4), 64
    cfg = dataclasses.replace(_cfg(2), drift_tol=0.5, reuse_every=10)
    q, k, v = (_t(a) for a in _qkv(9, n))
    mesh = _seq_mesh(2)
    with dispatch_mesh(mesh):
        _, s1 = attention_dispatch(q, k, v, grid=grid, cfg=cfg, step=0,
                                   total_steps=20, backend="reference",
                                   policy="ripple", return_decision=True)
        q2, k2 = q.clone(), k.clone()
        q2[..., n // 2:, :] *= 5.0
        k2[..., n // 2:, :] *= 5.0
        _, s2 = attention_dispatch(q2, k2, v, grid=grid, cfg=cfg, step=1,
                                   total_steps=20, backend="reference",
                                   policy="ripple", cached_decision=s1,
                                   return_decision=True)
    assert (s2.refreshes[..., 1] == 2).all()
    assert (s2.refreshes[..., 0] == 1).all()
    assert (s2.hits[..., 0] == 1).all() and (s2.hits[..., 1] == 0).all()
    assert torch.equal(s2.q_idx[..., :n // 2, :], s1.q_idx[..., :n // 2, :])


@pytest.mark.parametrize("ways", [2, 4])
def test_elided_hops_equal_all_skip_slices_of_the_unsharded_map(shards,
                                                                ways):
    """The ring skips exactly the hops whose slice of the unsharded svg
    block map is all-SKIP in every batch row and head (128-token tiles:
    each shard's rows are whole tiles at (8, 8, 8))."""
    grid = (8, 8, 8)
    q, k, v = (_t(a) for a in _qkv(12, 512))
    cfg = _cfg()
    pol = get_policy("svg")
    bmap = pol.decide(q, k, grid=grid, cfg=cfg, thetas=pol.thetas_for(
        cfg, STEP, TOTAL), block_shape=(128, 128)).block_map
    t = bmap.shape[-1] // ways
    want = sum(bool((bmap[..., a * t:(a + 1) * t, b * t:(b + 1) * t]
                     == SKIP).all()) for a in range(ways) for b in range(ways))
    _, state = _scan(q, k, v, grid, cfg, "svg", _seq_mesh(ways), 1)
    assert int(state.elided.sum()) == want > 0


# ---------------------------------------------------------------------------
# The JAX ring itself
# ---------------------------------------------------------------------------

_JAX_RING = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.config.base import RippleConfig
from repro.core.dispatch import attention_dispatch, dispatch_mesh
from repro.launch.mesh import parse_mesh_spec

data = np.load(sys.argv[1])
q, k, v = (jnp.asarray(data[n]) for n in "qkv")
grid = tuple(int(g) for g in data["grid"])
cfg = RippleConfig(enabled=True, theta_min=0.2, theta_max=0.5, i_min=2,
                   i_max=6, window=2)
kw = dict(grid=grid, cfg=cfg, step=jnp.asarray(%(step)d),
          total_steps=%(total)d)
with dispatch_mesh(parse_mesh_spec("1x1x2")):
    ripple = jax.jit(lambda q, k, v: attention_dispatch(
        q, k, v, policy="ripple", backend="reference", **kw))(q, k, v)
    svg, state = jax.jit(lambda q, k, v: attention_dispatch(
        q, k, v, policy="svg", return_decision=True, **kw))(q, k, v)
np.savez(sys.argv[2], ripple=np.asarray(ripple), svg=np.asarray(svg),
         elided=np.asarray(state.elided))
"""


def test_port_ring_matches_the_jax_ring(tmp_path, multidevice_env, shards):
    """The JAX ring on 8 virtual CPU devices at 2 ways (a subprocess: JAX
    fixes its device count at start; each call jitted, one compile
    instead of one a primitive) against the port's on 2 CPU shards:
    ripple and svg outputs at the port's dispatch tolerance, and the svg
    ring's per-shard elided counts equal."""
    grid = (8, 8, 8)
    q, k, v = _qkv(13, 512)
    src = tmp_path / "in.npz"
    dst = tmp_path / "out.npz"
    np.savez(src, q=q, k=k, v=v, grid=np.asarray(grid))
    script = _JAX_RING % {"step": STEP, "total": TOTAL}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", script, str(src), str(dst)],
                         env=multidevice_env, cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    want = np.load(dst)
    mesh = _seq_mesh(2)
    tq, tk, tv = _t(q), _t(k), _t(v)
    got = _dispatch(tq, tk, tv, grid, _cfg(), "ripple", mesh)
    np.testing.assert_allclose(got.numpy(), want["ripple"], atol=1e-5, rtol=0)
    with dispatch_mesh(mesh):
        svg, state = attention_dispatch(
            tq, tk, tv, grid=grid, cfg=_cfg(), step=STEP, total_steps=TOTAL,
            policy="svg", return_decision=True)
    np.testing.assert_allclose(svg.numpy(), want["svg"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(state.elided.numpy(), want["elided"])
    assert int(want["elided"].sum()) > 0

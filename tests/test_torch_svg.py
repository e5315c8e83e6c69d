"""The port's SVG block-mask slice against the JAX package: the masks,
the head verdicts, the keep-mask and bias, the block maps at the serving
grid, plan resolution of the sparse backend, the dispatch seam under
``svg`` and under ripple + ``svg_mask``, and a short vDiT trajectory
under each, on inputs made with numpy from a seed."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import RippleConfig as JRippleConfig  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core import dispatch as j_dispatch  # noqa: E402
from repro.core import svg_mask as j_svg  # noqa: E402
from repro.diffusion.sampler import ddim_sample as j_ddim  # noqa: E402
from repro.diffusion.schedule import DDPMSchedule as JDDPM  # noqa: E402
from repro.kernels.sparse.ops import \
    block_map_from_keep as j_block_map_from_keep  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.models.vdit import vdit_apply as j_vdit_apply  # noqa: E402
from repro.models.vdit import vdit_defs  # noqa: E402
from repro_torch.config.base import RippleConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core import svg_mask  # noqa: E402
from repro_torch.diffusion.sampler import ddim_sample  # noqa: E402
from repro_torch.diffusion.schedule import DDPMSchedule  # noqa: E402
from repro_torch.kernels.sparse.ops import (  # noqa: E402
    FULL, PARTIAL, SKIP, block_map_from_keep)
from repro_torch.models.params import params_from_numpy  # noqa: E402

torch.set_num_threads(2)

GRIDS = [(4, 4, 6), (2, 3, 5), (1, 4, 4)]


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("grid", GRIDS)
def test_masks_bit_equal_to_jax(grid):
    np.testing.assert_array_equal(svg_mask.spatial_mask(grid),
                                  j_svg.spatial_mask(grid))
    for halo in (1, 2):
        np.testing.assert_array_equal(svg_mask.temporal_mask(grid, halo),
                                      j_svg.temporal_mask(grid, halo))
    assert svg_mask.mask_density(svg_mask.spatial_mask(grid)) == \
        j_svg.mask_density(j_svg.spatial_mask(grid))


def _structured_qk(grid, d, seed, H_random=1):
    """(1, 2 + H_random, N, d) operands: head 0 shares one vector per
    frame (a spatial head), head 1 one vector per spatial site (a
    temporal head), the rest are random.  Scaled so a matching pair's
    logit is ~40 against ~±7 for the others."""
    T, Hg, Wg = grid
    n = T * Hg * Wg
    rng = np.random.default_rng(seed)

    def unit(m):
        x = rng.standard_normal((m, d))
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    alpha = np.sqrt(40.0 * np.sqrt(d))
    frame = alpha * unit(T)[np.repeat(np.arange(T), Hg * Wg)]
    site = alpha * unit(Hg * Wg)[np.tile(np.arange(Hg * Wg), T)]
    rand = rng.standard_normal((H_random, n, d))
    x = np.concatenate([frame[None], site[None], rand], 0)[None]
    return x.astype(np.float32), (x + 0.01 * rng.standard_normal(
        x.shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", GRIDS[:2])
def test_classify_heads_bit_equal_to_jax(grid, dtype):
    q, k = _structured_qk(grid, 32, seed=1)
    want = np.asarray(j_svg.classify_heads(jnp.asarray(q, dtype),
                                           jnp.asarray(k, dtype), grid))
    got = svg_mask.classify_heads(_t(q).to(getattr(torch, dtype)),
                                  _t(k).to(getattr(torch, dtype)), grid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] and not want[0, 1]  # one head of each kind


def test_classify_heads_random_operands_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    q, k = (rng.standard_normal((2, 4, 96, 16)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_array_equal(
        svg_mask.classify_heads(_t(q), _t(k), (4, 4, 6)).numpy(),
        np.asarray(j_svg.classify_heads(jnp.asarray(q), jnp.asarray(k),
                                        (4, 4, 6))))


@pytest.mark.parametrize("grid_slice,with_bias", [
    (None, False), ((8, 96), False), ((8, 96), True), ((0, 96), False)])
def test_svg_logit_bias_bit_equal_to_jax(grid_slice, with_bias):
    grid = (4, 4, 6)
    n_txt = 0 if grid_slice is None else grid_slice[0]
    qg, kg = _structured_qk(grid, 32, seed=3)
    rng = np.random.default_rng(4)
    txt = rng.standard_normal((2, 1, 3, n_txt, 32)).astype(np.float32)
    q = np.concatenate([txt[0], qg], axis=-2)
    k = np.concatenate([txt[1], kg], axis=-2)
    N = q.shape[-2]
    bias = (rng.standard_normal((1, 3, N, N)).astype(np.float32)
            if with_bias else None)
    j_keep, j_bias = j_svg.svg_logit_bias(
        jnp.asarray(q), jnp.asarray(k), grid, grid_slice,
        None if bias is None else jnp.asarray(bias))
    keep, got = svg_mask.svg_logit_bias(
        _t(q), _t(k), grid, grid_slice, None if bias is None else _t(bias))
    np.testing.assert_array_equal(keep.numpy(), _np(j_keep))
    np.testing.assert_array_equal(got.numpy(), _np(j_bias))
    if grid_slice is not None and n_txt:
        assert keep[..., :n_txt, :].all() and keep[..., :, :n_txt].all()


@pytest.mark.parametrize("grid_slice", [None, (8, 96)])
def test_svg_policy_savings_bit_equal_to_jax(grid_slice):
    """The SVG policy's savings (1 - keep density) counted from the head
    verdicts equals JAX's mean over the whole keep-mask, with heads of
    both kinds in a batch of 2, text tokens dense or absent."""
    from repro.core.policy import get_policy as j_get_policy
    from repro_torch.core.policy import get_policy

    grid = (4, 4, 6)
    n_txt = 0 if grid_slice is None else grid_slice[0]
    qs, ks = zip(*(_structured_qk(grid, 32, seed=s, H_random=2) for s in (12, 13)))
    rng = np.random.default_rng(14)
    txt = rng.standard_normal((2, 2, 4, n_txt, 32)).astype(np.float32)
    q = np.concatenate([txt[0], np.concatenate(qs)], axis=-2)
    k = np.concatenate([txt[1], np.concatenate(ks)], axis=-2)
    thetas = {"t": 0.0, "x": 0.0, "y": 0.0}
    want = j_get_policy("svg").decide(
        jnp.asarray(q), jnp.asarray(k), grid=grid, cfg=JRippleConfig(**CFG),
        thetas=thetas, grid_slice=grid_slice).savings
    got = get_policy("svg").decide(
        _t(q), _t(k), grid=grid, cfg=RippleConfig(**CFG), thetas=thetas,
        grid_slice=grid_slice)
    assert got.savings.dtype == torch.float32 and got.savings.shape == ()
    np.testing.assert_array_equal(got.savings.numpy(), np.asarray(want))


def test_serving_grid_block_maps_bit_equal_to_jax():
    """vdit-paper's serving grid (8, 32, 32) after 256 text tokens, 128
    tiles: a spatial head's map is 1220 FULL, 0 PARTIAL, 3136 SKIP of
    4356 tiles, a temporal head's 260 FULL, 1408 PARTIAL, 2688 SKIP."""
    grid, n_txt = (8, 32, 32), 256
    qg, kg = _structured_qk(grid, 32, seed=5, H_random=0)
    txt = np.random.default_rng(6).standard_normal(
        (2, 1, 2, n_txt, 32)).astype(np.float32)
    q = np.concatenate([txt[0], qg], axis=-2)
    k = np.concatenate([txt[1], kg], axis=-2)
    gs = (n_txt, 8192)
    j_keep, _ = j_svg.svg_logit_bias(jnp.asarray(q), jnp.asarray(k), grid, gs)
    want = np.asarray(j_block_map_from_keep(j_keep, 128, 128))
    del j_keep
    keep, _ = svg_mask.svg_logit_bias(_t(q), _t(k), grid, gs)
    got = block_map_from_keep(keep, 128, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    counts = [tuple(int((got[0, h] == s).sum()) for s in (FULL, PARTIAL, SKIP))
              for h in range(2)]
    assert counts == [(1220, 0, 3136), (260, 1408, 2688)]


# ---------------------------------------------------------------------------
# Plan resolution and the dispatch seam
# ---------------------------------------------------------------------------

GRID = (4, 4, 6)
N_TXT = 8
N = N_TXT + 96
CFG = dict(enabled=True, theta_min=0.2, theta_max=0.5, i_min=2, i_max=6)


@pytest.mark.parametrize("policy,svg,backend,has_bias", [
    ("svg", False, None, False), ("svg", False, "sparse", False),
    ("svg", False, None, True), ("svg", False, "pallas", False),
    ("svg", False, "sparse", True), ("ripple", True, None, False),
    ("ripple", True, "pallas", False), ("ripple", True, "collapse", True),
    ("ripple", False, "sparse", False), ("ripple", False, None, False),
    ("ripple", True, "reference", False), ("dense", False, "sparse", False),
])
def test_resolve_backend_matches_jax(policy, svg, backend, has_bias):
    """On the CPU the port resolves as the JAX package does on its CPU;
    on CUDA operands only a ripple plan without a mask may turn to the
    ripple kernel instead of the reference."""
    kw = dict(CFG, policy=policy, svg_mask=svg)
    want = j_dispatch.resolve_backend(JRippleConfig(**kw), backend,
                                      has_bias=has_bias, n_tokens=N)
    got = dispatch.resolve_backend(RippleConfig(**kw), backend,
                                   has_bias=has_bias, n_tokens=N,
                                   on_cuda=False)
    assert got == want
    on_cuda = dispatch.resolve_backend(RippleConfig(**kw), backend,
                                       has_bias=has_bias, n_tokens=N,
                                       on_cuda=True)
    assert on_cuda == got or (got, on_cuda) == ("reference", "pallas")


def test_sparse_plans_and_summaries():
    dispatch._PLAN_CACHE.clear()
    shape = (1, 2, N, 16)
    p = dispatch.resolve_plan(shape, shape, RippleConfig(**CFG),
                              on_cuda=True, policy="svg")
    assert (p.backend, p.block_q, p.block_k) == ("sparse", 128, 128)
    assert "svg/sparse block=128x128" in p.summary()
    cfg = RippleConfig(**CFG, svg_mask=True, backend="pallas")
    p = dispatch.resolve_plan(shape, shape, cfg, on_cuda=True)
    assert "ripple/sparse block=128x128" in p.summary()
    p = dispatch.resolve_plan(shape, shape, RippleConfig(**CFG),
                              on_cuda=False, policy="svg", has_bias=True)
    assert p.backend == "reference"


def _dispatch_inputs(seed):
    qg, kg = _structured_qk(GRID, 16, seed)
    rng = np.random.default_rng(seed + 1)
    txt = rng.standard_normal((2, 1, 3, N_TXT, 16)).astype(np.float32)
    q = np.concatenate([txt[0], qg], axis=-2)
    k = np.concatenate([txt[1], kg], axis=-2)
    v = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("policy,svg,backend", [
    ("svg", False, None), ("ripple", True, None), ("ripple", False, "sparse"),
    ("svg", False, "reference")])
def test_attention_dispatch_matches_jax(policy, svg, backend):
    """f32: the same masks and snaps on both sides; the JAX sparse kernel
    (interpret mode) sums online over tiles, the port's plain version at
    once — only summation order differs."""
    q, k, v = _dispatch_inputs(7)
    kw = dict(CFG, policy=policy, svg_mask=svg)
    thetas = {"t": 0.3, "x": 0.3, "y": 0.3}
    gs = (N_TXT, 96)
    want = j_dispatch.attention_dispatch(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), grid=GRID,
        cfg=JRippleConfig(**kw), thetas=thetas, grid_slice=gs,
        backend=backend)
    got = dispatch.attention_dispatch(
        _t(q), _t(k), _t(v), grid=GRID, cfg=RippleConfig(**kw),
        thetas=thetas, grid_slice=gs, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# A short vDiT trajectory under each policy
# ---------------------------------------------------------------------------

J_ARCH = j_smoke_config("vdit-paper")
T_ARCH = get_smoke_config("vdit-paper")
STEPS = 12  # step 10 snaps at θ = 0.2 under ripple


@pytest.fixture(scope="module")
def tree():
    """The JAX param tree of the 2-layer smoke vDiT with every leaf
    redrawn from a seeded numpy generator at fan-in scale."""
    params = init_params(vdit_defs(J_ARCH.model), jax.random.PRNGKey(0))
    rng = np.random.default_rng(10)

    def draw(path, leaf):
        a = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        per_layer = a.shape[1:] if "blocks" in name else a.shape
        fan = per_layer[0] if len(per_layer) else 1
        x = rng.standard_normal(a.shape) / np.sqrt(fan)
        if "norm" in name:
            x = 1.0 + 0.1 * rng.standard_normal(a.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.mark.parametrize("policy,svg", [("svg", False), ("ripple", True)])
def test_ddim_trajectory_matches_jax(tree, policy, svg):
    """12 DDIM steps in f32 from the same params and noise: relative L2
    below 1e-3 (the per-step f32 summation-order noise carried through
    the trajectory)."""
    assert J_ARCH.model.num_layers == T_ARCH.model.num_layers == 2
    rng = np.random.default_rng(11)
    m = J_ARCH.model
    lat = rng.standard_normal((1, 4, 8, 8, m.in_channels)).astype(np.float32)
    txt = (0.05 * rng.standard_normal((1, m.txt_tokens, m.txt_dim))).astype(
        np.float32)
    j_rip = dataclasses.replace(J_ARCH.ripple, policy=policy, svg_mask=svg)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_txt = jnp.asarray(txt)

    def j_denoise(x, t, step):
        return j_vdit_apply(j_params, x, t, j_txt, m, ripple=j_rip,
                            step=step, total_steps=STEPS,
                            compute_dtype=jnp.float32).astype(x.dtype)

    want = np.asarray(jax.jit(lambda x: j_ddim(j_denoise, x, JDDPM(), STEPS))(
        jnp.asarray(lat)))

    model = params_from_numpy(tree, T_ARCH.model, device="cpu")
    t_rip = dataclasses.replace(T_ARCH.ripple, policy=policy, svg_mask=svg)
    t_txt = torch.from_numpy(txt)

    def denoise(x, t, step):
        return model(x, t, t_txt, ripple=t_rip, step=step, total_steps=STEPS,
                     compute_dtype=torch.float32).to(x.dtype)

    got = ddim_sample(denoise, torch.from_numpy(lat), DDPMSchedule(),
                      STEPS).numpy()
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-3, rel

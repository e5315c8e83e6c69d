"""The port's UNet slice against the JAX package at the smoke config
(ch 32, ch_mult 1-2, 4 heads: head dims 8 and 16, latents 8 x 8 x 4,
text 5 x 32): the configs, every parameter leaf crossing through
``params_from_numpy`` (convolution weights transposed), the convolution
substrate (the stride-2 "SAME" conv pads XLA's way), one forward at a
snapping step, a DDIM trajectory against the JAX launcher's sampler, the
launcher serving ``unet-sd15`` on the CPU, and the dispatch plan at the
full config's head dims 40, 80 and 160."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.core.dispatch import attention_dispatch as j_dispatch  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.launch import workloads as j_workloads  # noqa: E402
from repro.models import conv as j_conv  # noqa: E402
from repro.models.params import ParamDef  # noqa: E402
from repro.models.unet import unet_apply as j_unet_apply  # noqa: E402
from repro.models.unet import unet_defs  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.kernels.ripple import ops as ripple_ops  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch.workloads import (attention_shapes,  # noqa: E402
                                          latent_shape_for,
                                          mixed_request_stream)
from repro_torch.models import conv  # noqa: E402
from repro_torch.models.params import (init_unet, iter_specs,  # noqa: E402
                                       params_from_numpy, to_port,
                                       unet_param_specs)
from repro_torch.models.unet import unet_apply  # noqa: E402

torch.set_num_threads(2)

J_ARCH = j_get_smoke("unet-sd15")
ARCH = get_smoke_config("unet-sd15")
STEPS = 12  # step 10 snaps at θ = 0.2, step 11 runs dense


def _key(k):
    return getattr(k, "key", getattr(k, "idx", k))


@pytest.fixture(scope="module")
def tree():
    """The JAX param tree with every leaf redrawn from a seeded numpy
    generator: weights at fan-in scale, norm scales around 1, biases
    small but non-zero."""
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        shape = leaf.shape
        if len(shape) == 1:
            base = 1.0 if _key(path[-1]) == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
        fan = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, unet_defs(J_ARCH.model),
        is_leaf=lambda x: isinstance(x, ParamDef))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    m = J_ARCH.model
    lat = rng.standard_normal((2, m.latent_res, m.latent_res,
                               m.in_channels)).astype(np.float32)
    ctx = (0.5 * rng.standard_normal((2, m.ctx_tokens, m.ctx_dim))).astype(
        np.float32)
    return lat, np.array([500.0, 120.0], np.float32), ctx


def test_config_matches_jax():
    for j, t in ((j_get_config("unet-sd15"), get_config("unet-sd15")),
                 (J_ARCH, ARCH)):
        assert dataclasses.asdict(j.model) == dataclasses.asdict(t.model)
        assert dataclasses.asdict(j.ripple) == dataclasses.asdict(t.ripple)
        assert [dataclasses.asdict(s) for s in j.shapes] == \
            [dataclasses.asdict(s) for s in t.shapes]
        assert (j.name, j.family, j.source) == (t.name, t.family, t.source)


def test_params_from_numpy_covers_every_leaf(tree):
    j_paths = {tuple(_key(k) for k in path)
               for path, _ in jax.tree_util.tree_leaves_with_path(tree)}
    t_paths = {path for path, _ in iter_specs(unet_param_specs(ARCH.model))}
    assert j_paths == t_paths
    model = params_from_numpy(tree, ARCH.model, device="cpu")
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    w = tree["up"][0]["res"][1]["conv1"]["w"]  # (3, 3, c_in, c_out)
    np.testing.assert_array_equal(model.up[0].res[1].conv1.w.numpy(),
                                  w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.mid.attn.cross_k.numpy(),
                                  tree["mid"]["attn"]["cross_k"])
    assert model.down[0].res[0].skip is None  # c_in == c_out
    assert model.up[0].res[0].skip is not None  # skip channels concatenated
    assert not hasattr(model.down[-1], "down") and hasattr(model.up[0], "up")


def test_init_unet_zero_init_follows_the_jax_defs():
    model = init_unet(ARCH.model, seed=0, device="cpu")
    assert not model.conv_in.b.any() and (model.norm_out.scale == 1).all()
    w = model.down[0].res[0].conv1.w  # fan-in 3 * 3 * 32
    assert w.std().item() == pytest.approx((1 / 288) ** 0.5, rel=0.1)
    served = init_unet(ARCH.model, seed=0, device="cpu", zero_init=False)
    assert served.conv_in.b.any() and (served.norm_out.scale != 1).any()


def test_same_padding_is_xlas():
    assert conv.same_padding(8, 3, 2) == (0, 1)   # even: the odd pixel after
    assert conv.same_padding(7, 3, 2) == (1, 1)
    assert conv.same_padding(8, 3, 1) == (1, 1)
    assert conv.same_padding(8, 1, 1) == (0, 0)


@pytest.mark.parametrize("k,stride,size", [
    (3, 1, 8), (3, 1, 7), (1, 1, 6), (3, 2, 8), (3, 2, 7), (3, 2, 6)])
def test_conv2d_matches_jax(k, stride, size):
    rng = np.random.default_rng(k * 100 + stride * 10 + size)
    x = rng.standard_normal((2, size, size + 2, 6)).astype(np.float32)
    p = {"w": rng.standard_normal((k, k, 6, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    want = np.asarray(j_conv.conv2d(jax.tree_util.tree_map(jnp.asarray, p),
                                    jnp.asarray(x), stride=stride))
    c = conv.Conv(k, 6, 5)
    with torch.no_grad():
        c.w.copy_(to_port(torch.from_numpy(p["w"])))
        c.b.copy_(torch.from_numpy(p["b"]))
    got = conv.conv2d(c, torch.from_numpy(x), stride=stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("channels", [40, 48, 320, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_matches_jax(channels, dtype):
    """C not divisible by 32 falls back to the largest group count that
    divides it (20 for 40, 24 for 48); one rounding to x's dtype."""
    rng = np.random.default_rng(channels)
    x = (3.0 + rng.standard_normal((2, 4, 6, channels))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(channels)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(channels)).astype(np.float32)}
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(j_conv.groupnorm(
        jax.tree_util.tree_map(jnp.asarray, p), xj).astype(jnp.float32))
    gn = conv.Norm(channels)
    with torch.no_grad():
        gn.scale.copy_(torch.from_numpy(p["scale"]))
        gn.bias.copy_(torch.from_numpy(p["bias"]))
    got = conv.groupnorm(gn, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # f32: the statistics' summation order; bf16: one ulp of the result.
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_upsample_nearest_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    want = np.asarray(j_conv.upsample_nearest(jnp.asarray(x), 2))
    got = conv.upsample_nearest(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)


# Relative L2 of the forward.  f32: both sides compute in f32 and snap
# the same entries; the gap is summation order (~1e-6).  bf16: every
# conv, matmul and elementwise op rounds to bf16 in a different place in
# XLA and ATen (F.conv2d adds its bias before rounding, F.silu rounds
# once), and a rounding flips a snap decision near θ now and then; on
# these weights the JAX bf16 forward itself lies 2-4% from its f32 one
# (3.7% at step 10), and the port's bf16 forward 3.8% from JAX's.
FWD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_at_a_snapping_step(tree, dtype):
    """Step 10 of 12 (θ 0.2 on x/y at both attention levels), the JAX side
    through its fused Δ-check and ripple Pallas kernels in interpret
    mode, the port through their plain versions on the CPU.  The JAX
    forward is jitted (twice as fast as eager; the same values to 2e-6
    in f32; in bf16, where XLA may keep intermediates in f32, the jitted
    and the eager forward lie 3.7% apart, as far as either lies from the
    port's)."""
    lat, t, ctx = _inputs(1)
    j_rip = dataclasses.replace(J_ARCH.ripple, backend="pallas",
                                fused_mask="on")

    def j_fwd(p, x, tt, c):
        return j_unet_apply(p, x, tt, c, J_ARCH.model, ripple=j_rip, step=10,
                            total_steps=STEPS,
                            compute_dtype=getattr(jnp, dtype))

    want = jax.jit(j_fwd)(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(lat),
                 jnp.asarray(t), jnp.asarray(ctx))
    want = np.asarray(want.astype(jnp.float32))
    model = params_from_numpy(tree, ARCH.model, device="cpu")
    t_rip = dataclasses.replace(ARCH.ripple, backend="pallas",
                                fused_mask="on")
    got = unet_apply(model, torch.from_numpy(lat), torch.from_numpy(t),
                     torch.from_numpy(ctx), ARCH.model, ripple=t_rip,
                     step=10, total_steps=STEPS,
                     compute_dtype=getattr(torch, dtype)).float().numpy()
    assert got.shape == want.shape == lat.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < FWD_TOL[dtype], rel


def test_ddim_trajectory_matches_the_jax_launcher(tree, monkeypatch):
    """Both launchers' samplers, 12 DDIM steps in float32 on the same
    params, noise and text context (the JAX one jitted, its model pinned
    to f32 as the port's ``compute_dtype``); steps 10 snaps."""
    orig = j_workloads.unet_lib.unet_apply
    monkeypatch.setattr(j_workloads.unet_lib, "unet_apply",
                        lambda *a, **kw: orig(*a, compute_dtype=jnp.float32,
                                              **kw))
    shape = serve_lib.serving_shape(ARCH, "gen_1024", smoke=True,
                                    steps=STEPS)
    j_shape = serve_lib.serving_shape(J_ARCH, "gen_1024", smoke=True,
                                      steps=STEPS)
    j_fn, lat_shape = j_serve.build_sampler(
        J_ARCH, j_shape, jax.tree_util.tree_map(jnp.asarray, tree))
    fn, t_lat_shape = serve_lib.build_sampler(
        ARCH, shape, params_from_numpy(tree, ARCH.model, device="cpu"),
        compute_dtype=torch.float32)
    assert tuple(lat_shape) == tuple(t_lat_shape) == (8, 8, 4)
    lat, _, ctx = _inputs(2)
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
    want = np.asarray(j_fn(jnp.asarray(lat), jnp.asarray(ctx), rngs))
    got = fn(torch.from_numpy(lat), torch.from_numpy(ctx)).numpy()
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-3, rel


def test_svg_trajectory_matches_the_jax_launcher(tree, monkeypatch):
    """``--policy svg`` on the UNet, as the JAX launcher serves it: both
    samplers under svg, 12 DDIM steps in float32 on the same params,
    noise and context.  On a T = 1 grid svg's spatial mask keeps every
    token, so every level's map is all-FULL and runs through the sparse
    backend (the JAX kernel in interpret mode, the port's plain version
    on the CPU)."""
    orig = j_workloads.unet_lib.unet_apply
    monkeypatch.setattr(j_workloads.unet_lib, "unet_apply",
                        lambda *a, **kw: orig(*a, compute_dtype=jnp.float32,
                                              **kw))
    shape = serve_lib.serving_shape(ARCH, "gen_1024", smoke=True,
                                    steps=STEPS)
    j_shape = serve_lib.serving_shape(J_ARCH, "gen_1024", smoke=True,
                                      steps=STEPS)
    j_fn, _ = j_serve.build_sampler(
        J_ARCH, j_shape, jax.tree_util.tree_map(jnp.asarray, tree),
        policy="svg")
    fn, _ = serve_lib.build_sampler(
        ARCH, shape, params_from_numpy(tree, ARCH.model, device="cpu"),
        policy="svg", compute_dtype=torch.float32)
    lat, _, ctx = _inputs(3)
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
    want = np.asarray(j_fn(jnp.asarray(lat), jnp.asarray(ctx), rngs))
    got = fn(torch.from_numpy(lat), torch.from_numpy(ctx)).numpy()
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-3, rel


def test_main_serves_unet_sd15_under_svg_on_cpu(caplog):
    """The launcher serves the UNet under ``--policy svg``: every
    attention level plans the block-sparse backend (on the card, the
    sparse kernel's tensor cores at d 40, 80 and 160)."""
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    done = serve_lib.main(["--arch", "unet-sd15", "--smoke", "--device",
                           "cpu", "--requests", "1", "--policy", "svg"])
    assert len(done) == 1 and np.isfinite(done[0].latents).all()
    assert ("plan 64 tokens x d 8: attention[svg/sparse block=128x128 "
            "bucket=(64, 64)]; 16 tokens x d 16: attention[svg/sparse"
            in caplog.text)


def test_main_serves_unet_sd15_on_cpu(caplog):
    """One plan line per attention level (head dims 8 and 16 at the smoke
    config), none built from a d_model the UNet does not have."""
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    done = serve_lib.main(["--arch", "unet-sd15", "--smoke", "--device",
                           "cpu", "--requests", "2"])
    assert [r.request_id for r in done] == [0, 1]
    # Mixed traffic: the base 64² shape, then its half resolution.
    assert [r.latents.shape for r in done] == [(8, 8, 4), (4, 4, 4)]
    for r in done:
        assert np.isfinite(r.latents).all()
    assert "unet-sd15-smoke (2 levels, ch 32, n_res_blocks 1)" in caplog.text
    assert ("plan 64 tokens x d 8: attention[ripple/reference "
            "bucket=(64, 64)]; 16 tokens x d 16: attention[ripple/reference"
            in caplog.text)


def test_serving_helpers_follow_the_reference():
    arch = get_config("unet-sd15")
    shape = arch.shape("gen_1024")
    assert latent_shape_for(arch, shape) == tuple(
        j_workloads.latent_shape_for(j_get_config("unet-sd15"), shape))
    assert attention_shapes(arch, shape) == [
        (16384, 40), (4096, 80), (1024, 160), (256, 160)]
    smoke = serve_lib.serving_shape(ARCH, "gen_1024", smoke=True)
    assert attention_shapes(ARCH, smoke) == [(64, 8), (16, 16)]


def test_request_stream_carries_the_unet_context():
    """A family without ``txt_tokens`` / ``txt_dim`` takes the context's
    77 x 768 (unet-sd15), as the reference's stream does."""
    arch = get_config("unet-sd15")
    j_arch = j_get_config("unet-sd15")
    sp = arch.shape("gen_1024")
    got = mixed_request_stream(arch, (sp,), 2, seed=3)
    want = j_workloads.mixed_request_stream(j_arch, (sp,), 2, seed=3)
    for (_, r), (_, jr) in zip(got, want):
        assert r.txt.shape == (77, 768)
        np.testing.assert_array_equal(r.txt, jr.txt)
        assert r.latent_shape == tuple(jr.latent_shape) == (128, 128, 4)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_dispatch_resolves_and_runs_the_kernel_plan(d):
    """On CUDA operands ``auto`` picks the ripple kernel at every head dim,
    as the JAX dispatch does; the kernel takes the UNet's and up to 256 (the
    largest a config serves) and refuses a larger one rather than falling
    back.  On the CPU the planned backend runs its plain version, equal to
    the JAX dispatch through its ripple Pallas kernel in interpret mode."""
    cfg = ARCH.ripple
    for dim in (d, 256, 264):
        shp = (4, 8, 1024, dim)
        assert dispatch.resolve_plan(shp, shp, cfg, on_cuda=True).backend \
            == "pallas"
    big = torch.zeros((1, 1, 64, 264))
    with pytest.raises(ValueError, match="head dims <= 256"):
        ripple_ops._launch(big, big, big, 1.0)
    rng = np.random.default_rng(d)
    grid = (1, 8, 8)
    q, k, v = (rng.standard_normal((1, 2, 64, d)).astype(np.float32)
               for _ in range(3))
    kw = dict(grid=grid, step=10, total_steps=STEPS)
    got = dispatch.attention_dispatch(
        *(torch.from_numpy(a) for a in (q, k, v)),
        cfg=dataclasses.replace(cfg, backend="pallas"), **kw).numpy()
    want = np.asarray(j_dispatch(
        *(jnp.asarray(a) for a in (q, k, v)),
        cfg=dataclasses.replace(J_ARCH.ripple, backend="pallas"), **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)

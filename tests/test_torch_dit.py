"""The port's DiT slice against the JAX package at a small config with
DiT-XL/2's head dim of 72 (d_model 144, 2 heads, 2 layers, img_res 128:
a (1, 8, 8) token grid): every parameter leaf randomised (the
zero-initialised adaLN-zero and final leaves included, or every block is
the identity), weights crossing through ``params_from_numpy``, class
labels passed explicitly; one forward at a step where θ > 0 with the JAX
side on its kernels' path, then a short DDIM trajectory from the same
numpy noise; and the launcher serving ``dit-xl2`` on the CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import DiTConfig as JDiTConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.diffusion.sampler import ddim_sample as j_ddim  # noqa: E402
from repro.diffusion.schedule import DDPMSchedule as JDDPM  # noqa: E402
from repro.models.common import sincos_pos_embed_2d as j_pos  # noqa: E402
from repro.models.dit import dit_apply as j_dit_apply  # noqa: E402
from repro.models.dit import dit_defs  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro_torch.config.base import DiTConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.diffusion.sampler import ddim_sample  # noqa: E402
from repro_torch.diffusion.schedule import DDPMSchedule  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch.workloads import request_label  # noqa: E402
from repro_torch.models.common import sincos_pos_embed_2d  # noqa: E402
from repro_torch.models.dit import dit_apply  # noqa: E402
from repro_torch.models.params import (dit_param_specs, init_dit,  # noqa: E402
                                       iter_specs, params_from_numpy)

torch.set_num_threads(2)

SMALL = dict(img_res=128, patch=2, num_layers=2, d_model=144, num_heads=2)
J_CFG = JDiTConfig(**SMALL)
T_CFG = DiTConfig(**SMALL)
J_RIPPLE = j_get_config("dit-xl2").ripple
T_RIPPLE = get_config("dit-xl2").ripple
STEPS = 12  # step 10 snaps at θ = 0.2, step 11 runs dense
LABELS = np.array([3, 999], np.int32)


@pytest.fixture(scope="module")
def tree():
    """The JAX param tree with every leaf redrawn from a seeded numpy
    generator at fan-in scale."""
    params = init_params(dit_defs(J_CFG), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        a = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        per_layer = a.shape[1:] if "blocks" in name else a.shape
        fan = per_layer[0] if len(per_layer) else 1
        return (rng.standard_normal(a.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _latents(seed):
    rng = np.random.default_rng(seed)
    lr = J_CFG.latent_res()
    return rng.standard_normal((2, lr, lr, J_CFG.in_channels)).astype(
        np.float32)


def test_config_matches_jax():
    for name in ("dit-xl2", "dit-b2"):
        j, t = j_get_config(name), get_config(name)
        assert dataclasses.asdict(j.model) == dataclasses.asdict(t.model)
        assert dataclasses.asdict(j.ripple) == dataclasses.asdict(t.ripple)
        assert [dataclasses.asdict(s) for s in j.shapes] == \
            [dataclasses.asdict(s) for s in t.shapes]
        assert (j.family, j.source) == (t.family, t.source)
        assert dataclasses.asdict(j.train) == dataclasses.asdict(t.train)
        assert dataclasses.asdict(j.checkpoint) == \
            dataclasses.asdict(t.checkpoint)
    m = get_config("dit-xl2").model
    assert m.d_model // m.num_heads == 72
    assert m.num_tokens(1024) == 64 * 64


def test_params_from_numpy_covers_every_leaf(tree):
    j_paths = {tuple(getattr(k, "key", k) for k in path)
               for path, _ in jax.tree_util.tree_leaves_with_path(tree)}
    t_paths = {path for path, _ in iter_specs(dit_param_specs(T_CFG))}
    assert j_paths == t_paths
    model = params_from_numpy(tree, T_CFG, device="cpu")
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    np.testing.assert_array_equal(model.blocks[1].mlp.bi.numpy(),
                                  tree["blocks"]["mlp"]["bi"][1])
    np.testing.assert_array_equal(model.label_embed.numpy(),
                                  tree["label_embed"])
    assert model.blocks[0].attn.q_norm is None  # DiT has no qk-norm


def test_init_dit_zero_init_follows_the_jax_defs():
    model = init_dit(T_CFG, seed=0, device="cpu")
    for blk in model.blocks:
        assert not blk.ada.w.any() and not blk.mlp.bi.any()
    assert not model.final.w.any() and not model.final_ada.w.any()
    assert model.label_embed.std().item() == pytest.approx(0.02, rel=0.05)
    served = init_dit(T_CFG, seed=0, device="cpu", zero_init=False)
    assert served.final.w.any() and served.blocks[0].ada.w.any()


def test_sincos_pos_embed_matches_jitted_jax():
    """ulp-level: XLA's and ATen's sin/cos round differently."""
    for h, w, d in ((8, 8, 144), (64, 64, 1152)):
        want = np.asarray(jax.jit(j_pos, static_argnums=(0, 1, 2))(h, w, d))
        got = sincos_pos_embed_2d(h, w, d).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


# Relative L2 tolerance of the forward.  f32: both sides compute in f32
# and snap the same entries; the gap is summation order (~1e-6).  bf16:
# every matmul and elementwise op rounds to bf16 in a different place in
# XLA and ATen (and the adaLN kernel rounds once where JAX rounds after
# the norm and after each modulation op), ~1% of the output norm.
FWD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_at_a_snapping_step(tree, dtype):
    lat = _latents(1)
    t = np.array([500.0, 120.0], np.float32)
    j_rip = dataclasses.replace(J_RIPPLE, backend="pallas", fused_mask="on")
    want = j_dit_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                       jnp.asarray(lat), jnp.asarray(t), jnp.asarray(LABELS),
                       J_CFG, ripple=j_rip, step=10, total_steps=STEPS,
                       compute_dtype=getattr(jnp, dtype))
    want = np.asarray(want.astype(jnp.float32))
    model = params_from_numpy(tree, T_CFG, device="cpu")
    t_rip = dataclasses.replace(T_RIPPLE, backend="pallas", fused_mask="on")
    got = dit_apply(model, torch.from_numpy(lat), torch.from_numpy(t),
                    torch.from_numpy(LABELS).long(), T_CFG, ripple=t_rip,
                    step=10, total_steps=STEPS,
                    compute_dtype=getattr(torch, dtype)).float().numpy()
    assert got.shape == want.shape == lat.shape[:3] + (8,)  # + sigma
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < FWD_TOL[dtype], rel


def test_ddim_trajectory_matches_jax(tree):
    """12 DDIM steps in f32 from the same noise and labels; step 10
    snaps.  The denoiser keeps the noise channels (sigma dropped), as
    both launchers do."""
    lat = _latents(2)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_labels = jnp.asarray(LABELS)
    c = J_CFG.in_channels

    def j_denoise(x, t, step):
        out = j_dit_apply(j_params, x, t, j_labels, J_CFG, ripple=J_RIPPLE,
                          step=step, total_steps=STEPS,
                          compute_dtype=jnp.float32)
        return out[..., :c].astype(x.dtype)

    want = np.asarray(jax.jit(lambda x: j_ddim(j_denoise, x, JDDPM(), STEPS))(
        jnp.asarray(lat)))

    model = params_from_numpy(tree, T_CFG, device="cpu")
    labels = torch.from_numpy(LABELS).long()

    def denoise(x, t, step):
        out = model(x, t, labels, ripple=T_RIPPLE, step=step,
                    total_steps=STEPS, compute_dtype=torch.float32)
        return out[..., :c].to(x.dtype)

    got = ddim_sample(denoise, torch.from_numpy(lat), DDPMSchedule(),
                      STEPS).numpy()
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-3, rel


def test_request_label_depends_on_the_seed_only():
    assert request_label(7, 1000) == request_label(7, 1000)
    assert len({request_label(s, 1000) for s in range(16)}) > 8
    assert all(0 <= request_label(s, 10) < 10 for s in range(32))


def test_sampler_labels_follow_each_request():
    """A request's result is the same alone and beside another request
    (up to the f32 summation order of batch-size-dependent matmuls,
    which DDIM's first step amplifies ~150-fold): its class label comes
    from its own seed, and another seed's label moves it far more."""
    arch = get_smoke_config("dit-xl2")
    shape = serve_lib.serving_shape(arch, "gen_1024", smoke=True)
    model = init_dit(arch.model, seed=2, device="cpu", zero_init=False)
    fn, lat_shape = serve_lib.build_sampler(arch, shape, model,
                                            compute_dtype=torch.float32)
    assert lat_shape == (8, 8, 4)
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2,) + lat_shape).astype(np.float32))
    txt = torch.zeros((2, 8, 64))
    pair = fn(noise, txt, [5, 6])
    alone = fn(noise[1:], txt[1:], [6])
    other = fn(noise[1:], txt[1:], [7])
    assert request_label(6, 1000) != request_label(7, 1000)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    assert rel(pair[1:], alone) < 1e-4
    assert rel(other, alone) > 1e-2
    with pytest.raises(ValueError, match="one seed per request"):
        fn(noise, txt)


def test_main_serves_dit_xl2_on_cpu(caplog):
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    done = serve_lib.main(["--arch", "dit-xl2", "--smoke", "--device", "cpu",
                           "--requests", "2"])
    assert [r.request_id for r in done] == [0, 1]
    # Mixed traffic: the base 64² shape, then its half resolution.
    assert [r.latents.shape for r in done] == [(8, 8, 4), (4, 4, 4)]
    for r in done:
        assert np.isfinite(r.latents).all()
    assert "dit-xl2-smoke (2 layers) at gen_1024" in caplog.text
    assert "attention[ripple/reference" in caplog.text

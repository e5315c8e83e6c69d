"""The port's vDiT slice against the JAX package at the smoke config:
every parameter leaf randomised (the zero-initialised adaLN and final
leaves included, or every block is the identity), weights crossing
through ``params_from_numpy``; one forward at a step where θ > 0 with
the JAX side on its kernels' path, then a short DDIM trajectory from the
same numpy noise."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.diffusion.sampler import ddim_sample as j_ddim  # noqa: E402
from repro.diffusion.schedule import DDPMSchedule as JDDPM  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.models.vdit import vdit_apply as j_vdit_apply  # noqa: E402
from repro.models.vdit import vdit_defs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.diffusion.sampler import ddim_sample, ddim_timesteps  # noqa: E402
from repro_torch.diffusion.schedule import DDPMSchedule  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

torch.set_num_threads(2)

J_ARCH = j_smoke_config("vdit-paper")
T_ARCH = get_smoke_config("vdit-paper")
STEPS = 12  # step 10 snaps at θ = 0.2, step 11 runs dense


@pytest.fixture(scope="module")
def tree():
    """The JAX param tree with every leaf redrawn from a seeded numpy
    generator at fan-in scale (norm scales around 1)."""
    params = init_params(vdit_defs(J_ARCH.model), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

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


def _inputs(seed):
    rng = np.random.default_rng(seed)
    m = J_ARCH.model
    lat = rng.standard_normal((1, 4, 8, 8, m.in_channels)).astype(np.float32)
    txt = (0.05 * rng.standard_normal((1, m.txt_tokens, m.txt_dim))).astype(
        np.float32)
    return lat, txt


def test_params_from_numpy_covers_every_leaf(tree):
    model = params_from_numpy(tree, T_ARCH.model, device="cpu")
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    np.testing.assert_array_equal(model.blocks[1].attn.wq.numpy(),
                                  tree["blocks"]["attn"]["wq"][1])
    assert float(np.abs(tree["final"]["w"]).max()) > 0  # not the identity


# Relative L2 tolerance of the forward.  f32: both sides compute in f32
# and snap the same entries; the gap is summation order (~1e-6).  bf16:
# every matmul and elementwise op rounds to bf16 in a different place in
# XLA and ATen, ~1% of the output norm over two layers.
FWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_at_a_snapping_step(tree, dtype):
    lat, txt = _inputs(1)
    t = np.array([500.0], np.float32)
    j_rip = dataclasses.replace(J_ARCH.ripple, backend="pallas",
                                fused_mask="on")
    want = j_vdit_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                        jnp.asarray(lat), jnp.asarray(t), jnp.asarray(txt),
                        J_ARCH.model, ripple=j_rip, step=10,
                        total_steps=STEPS,
                        compute_dtype=getattr(jnp, dtype))
    want = np.asarray(want.astype(jnp.float32))
    model = params_from_numpy(tree, T_ARCH.model, device="cpu")
    t_rip = dataclasses.replace(T_ARCH.ripple, backend="pallas",
                                fused_mask="on")
    got = model(torch.from_numpy(lat), torch.from_numpy(t),
                torch.from_numpy(txt), ripple=t_rip, step=10,
                total_steps=STEPS,
                compute_dtype=getattr(torch, dtype)).float().numpy()
    assert got.shape == want.shape == lat.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < FWD_TOL[dtype], rel


def test_ddim_timesteps_match_jax():
    for total in (3, 12, 28, 50):
        want = np.asarray(jnp.linspace(999, 0, total).astype(jnp.int32))
        np.testing.assert_array_equal(ddim_timesteps(DDPMSchedule(), total),
                                      want)
    np.testing.assert_allclose(DDPMSchedule().alpha_bars().numpy(),
                               np.asarray(JDDPM().alpha_bars()), rtol=1e-5)


def test_ddim_trajectory_matches_jax(tree):
    """12 DDIM steps in f32 from the same noise; step 10 snaps.  The gap
    is the per-step f32 summation-order noise carried through the
    trajectory (1e-3 of the latents' norm)."""
    lat, txt = _inputs(2)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_txt = jnp.asarray(txt)

    def j_denoise(x, t, step):
        return j_vdit_apply(j_params, x, t, j_txt, J_ARCH.model,
                            ripple=J_ARCH.ripple, step=step,
                            total_steps=STEPS,
                            compute_dtype=jnp.float32).astype(x.dtype)

    want = np.asarray(jax.jit(lambda x: j_ddim(j_denoise, x, JDDPM(), STEPS))(
        jnp.asarray(lat)))

    model = params_from_numpy(tree, T_ARCH.model, device="cpu")
    t_txt = torch.from_numpy(txt)

    def denoise(x, t, step):
        return model(x, t, t_txt, ripple=T_ARCH.ripple, step=step,
                     total_steps=STEPS,
                     compute_dtype=torch.float32).to(x.dtype)

    got = ddim_sample(denoise, torch.from_numpy(lat), DDPMSchedule(),
                      STEPS).numpy()
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-3, rel


def test_chunked_sampling_equals_monolithic(tree):
    """step_offset / total_steps chunks chain to the single run exactly."""
    lat, txt = _inputs(3)
    model = params_from_numpy(tree, T_ARCH.model, device="cpu")
    t_txt = torch.from_numpy(txt)

    def denoise(x, t, step):
        return model(x, t, t_txt, ripple=T_ARCH.ripple, step=step,
                     total_steps=STEPS,
                     compute_dtype=torch.float32).to(x.dtype)

    x0 = torch.from_numpy(lat)
    full = ddim_sample(denoise, x0, DDPMSchedule(), STEPS)
    x = ddim_sample(denoise, x0, DDPMSchedule(), 7, total_steps=STEPS)
    x = ddim_sample(denoise, x, DDPMSchedule(), 5, step_offset=7,
                    total_steps=STEPS)
    assert torch.equal(full, x)

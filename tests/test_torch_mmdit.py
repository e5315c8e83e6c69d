"""The port's MMDiT slice (flux-dev) against the JAX package at the smoke
config (d 64, 4 heads of 16, 2 + 2 blocks, text 8 x 64, latents 8 x 8 x
4: 16 image tokens after 8 text tokens): the configs, every parameter
leaf crossing through ``params_from_numpy`` (the layer-stacked double and
single trees split per layer), the forward with ripple off and on, the
Euler rectified-flow trajectory of the launcher's sampler, streaming and
resume, the attention shapes and bucket keys, the launcher serving
``flux-dev`` on the CPU, and ``cfg_wrap``."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.diffusion import sampler as j_sampler  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.launch import workloads as j_workloads  # noqa: E402
from repro.models.mmdit import mmdit_apply as j_mmdit_apply  # noqa: E402
from repro.models.mmdit import mmdit_defs  # noqa: E402
from repro.models.params import ParamDef  # noqa: E402
from repro.serving import engine as j_engine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.diffusion.sampler import cfg_wrap  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch.workloads import (attention_shapes,  # noqa: E402
                                          latent_shape_for,
                                          mixed_request_stream)
from repro_torch.models.mmdit import mmdit_apply  # noqa: E402
from repro_torch.models.params import (init_mmdit, iter_specs,  # noqa: E402
                                       mmdit_param_specs, params_from_numpy)
from repro_torch.serving.engine import DiffusionEngine  # noqa: E402
from repro_torch.serving.engine import request_noise  # noqa: E402
from test_torch_engine import _reference_summary_keys  # noqa: E402

torch.set_num_threads(2)

J_ARCH = j_get_smoke("flux-dev")
ARCH = get_smoke_config("flux-dev")
STEPS = 12  # step 10 snaps at θ = 0.2, step 11 runs dense


def _key(k):
    return getattr(k, "key", getattr(k, "idx", k))


@pytest.fixture(scope="module")
def tree():
    return draw_tree()


def draw_tree():
    """The JAX param tree with every leaf redrawn from a seeded numpy
    generator: weights at (per-layer) fan-in scale, norm scales around 1,
    biases and the zero-initialised ``mod``, ``final_mod`` and ``final``
    leaves non-zero, so that no block is the identity and the output is
    not 0."""
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        shape = leaf.shape
        per_layer = shape[1:] if _key(path[0]) in ("double", "single") \
            else shape
        if len(per_layer) == 1:
            base = 1.0 if _key(path[-1]) == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
        fan = int(np.prod(per_layer[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, mmdit_defs(J_ARCH.model),
        is_leaf=lambda x: isinstance(x, ParamDef))


def _inputs(seed, t=(0.8, 0.3)):
    rng = np.random.default_rng(seed)
    m = J_ARCH.model
    lat = rng.standard_normal((2, m.latent_res, m.latent_res,
                               m.in_channels)).astype(np.float32)
    txt = (0.5 * rng.standard_normal((2, m.txt_tokens, m.txt_dim))).astype(
        np.float32)
    vec = (0.5 * rng.standard_normal((2, 768))).astype(np.float32)
    return lat, np.array(t, np.float32), txt, vec


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_config_matches_jax():
    for j, t in ((j_get_config("flux-dev"), get_config("flux-dev")),
                 (J_ARCH, ARCH)):
        assert dataclasses.asdict(j.model) == dataclasses.asdict(t.model)
        assert dataclasses.asdict(j.ripple) == dataclasses.asdict(t.ripple)
        assert [dataclasses.asdict(s) for s in j.shapes] == \
            [dataclasses.asdict(s) for s in t.shapes]
        assert (j.name, j.family, j.source) == (t.name, t.family, t.source)
    assert not hasattr(ARCH.model, "num_layers")


def test_params_from_numpy_covers_every_leaf(tree):
    j_paths = {tuple(_key(k) for k in path)
               for path, _ in jax.tree_util.tree_leaves_with_path(tree)}
    t_paths = {path for path, _ in iter_specs(mmdit_param_specs(ARCH.model))}
    assert j_paths == t_paths
    model = params_from_numpy(tree, ARCH.model, device="cpu")
    j_leaves = jax.tree_util.tree_leaves(tree)
    assert sum(np.asarray(a).size for a in j_leaves) == \
        sum(p.numel() for p in model.parameters())
    m = ARCH.model
    # One port parameter a JAX leaf, a stacked leaf giving one a layer.
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(list(model.parameters())) == sum(
        np.asarray(a).shape[0] if _key(path[0]) in ("double", "single")
        else 1 for path, a in leaves)
    for i in range(m.n_double_blocks):
        for s in ("img", "txt"):
            blk = getattr(model.double_blocks, s)[i]
            np.testing.assert_array_equal(blk.wqkv.numpy(),
                                          tree["double"][s]["wqkv"][i])
            np.testing.assert_array_equal(blk.mod.w.numpy(),
                                          tree["double"][s]["mod"]["w"][i])
            np.testing.assert_array_equal(
                blk.q_norm.scale.numpy(),
                tree["double"][s]["q_norm"]["scale"][i])
    for i, blk in enumerate(model.single):
        np.testing.assert_array_equal(blk.lin1.numpy(),
                                      tree["single"]["lin1"][i])
        np.testing.assert_array_equal(blk.lin2_b.numpy(),
                                      tree["single"]["lin2_b"][i])
    np.testing.assert_array_equal(model.final.w.numpy(), tree["final"]["w"])
    np.testing.assert_array_equal(model.vec_in.w.numpy(), tree["vec_in"]["w"])


def test_init_mmdit_zero_init_follows_the_jax_defs():
    model = init_mmdit(ARCH.model, seed=0, device="cpu")
    assert not model.final.w.any() and not model.final_mod.w.any()
    assert not model.double_blocks.img[0].mod.w.any()
    assert not model.single[1].lin1_b.any()
    assert (model.single[0].q_norm.scale == 1).all()
    w = model.single[0].lin1  # fan-in d 64
    assert w.std().item() == pytest.approx(1 / 8, rel=0.1)
    served = init_mmdit(ARCH.model, seed=0, device="cpu", zero_init=False)
    assert served.final.w.any() and served.double_blocks.txt[1].mod.b.any()
    lat, t, txt, vec = (torch.from_numpy(a) for a in _inputs(4))
    zero = model(lat, t, txt, vec, compute_dtype=torch.float32)
    assert not zero.any()  # the JAX defs' zero final layer
    assert served(lat, t, txt, vec, compute_dtype=torch.float32).abs().sum() > 0


# Ripple off; on at step 10 of 12 (θ 0.2 on x/y: snapping) through the
# kernels' path (the JAX fused Δ-check and ripple Pallas kernels in
# interpret mode, the port's plain versions on the CPU); on at step 3 (a
# dense step of the schedule, θ 0, on the same path).
FWD_CASES = {"off": (False, 10), "snap": (True, 10), "dense-step": (True, 3)}


def _forward_pair(tree, ripple_on, step, dtype, seed):
    lat, t, txt, vec = _inputs(seed)
    kernels = dict(backend="pallas", fused_mask="on")
    j_rip = dataclasses.replace(J_ARCH.ripple, enabled=ripple_on, **kernels)
    t_rip = dataclasses.replace(ARCH.ripple, enabled=ripple_on, **kernels)

    def j_fwd(p, x, tt, c, v):
        return j_mmdit_apply(p, x, tt, c, v, J_ARCH.model, ripple=j_rip,
                             step=step, total_steps=STEPS,
                             compute_dtype=getattr(jnp, dtype))

    want = jax.jit(j_fwd)(jax.tree_util.tree_map(jnp.asarray, tree),
                          *(jnp.asarray(a) for a in (lat, t, txt, vec)))
    want = np.asarray(want.astype(jnp.float32))
    model = params_from_numpy(tree, ARCH.model, device="cpu")
    got = mmdit_apply(model, *(torch.from_numpy(a) for a in (lat, t, txt, vec)),
                      ARCH.model, ripple=t_rip, step=step, total_steps=STEPS,
                      compute_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert got.shape == want.shape == lat.shape
    return got, want


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_matches_jax_f32(tree, case, monkeypatch):
    """The port's joint attention snaps grid tokens only (about a fifth
    of Q and K at step 10 on these weights, none at step 3, the text rows
    never); the forward lies about 3e-7 from the JAX one."""
    ripple_on, step = FWD_CASES[case]
    pol = get_policy("ripple")
    orig = pol.decide
    snapped = []

    def decide(q, k, **kw):
        d = orig(q, k, **kw)
        s, n = kw["grid_slice"]
        assert s == ARCH.model.txt_tokens and n == 16
        assert not d.q_mask.narrow(-2, 0, s).any()
        assert not d.k_mask.narrow(-2, 0, s).any()
        snapped.append(d.q_mask.narrow(-2, s, n).float().mean().item())
        return d

    monkeypatch.setattr(pol, "decide", decide)
    got, want = _forward_pair(tree, ripple_on, step, "float32", 1)
    assert _rel(got, want) < 1e-3, _rel(got, want)
    m = ARCH.model
    assert len(snapped) == (m.n_double_blocks + m.n_single_blocks
                            if ripple_on else 0)
    if case == "snap":
        assert min(snapped) > 0.1
    else:
        assert not any(snapped)


# bf16: every matmul, norm and elementwise op rounds to bf16 in a
# different place in XLA (jitted, where intermediates may stay in f32)
# and ATen, across 4 blocks of residual updates, and a rounding flips a
# snap decision near θ now and then; on these weights the JAX bf16
# forward itself lies 0.81% from its f32 one at step 10, and the port's
# bf16 forward 0.87% from JAX's.  3e-2 leaves room for three times that.
BF16_TOL = 3e-2


def test_forward_matches_jax_bf16(tree):
    got, want = _forward_pair(tree, True, 10, "bfloat16", 2)
    _, want32 = _forward_pair(tree, True, 10, "float32", 2)
    assert _rel(want, want32) < BF16_TOL  # the reference's own bf16 gap
    assert _rel(got, want) < BF16_TOL, _rel(got, want)


def _j_f32(monkeypatch):
    orig = j_workloads.mmdit_lib.mmdit_apply
    monkeypatch.setattr(j_workloads.mmdit_lib, "mmdit_apply",
                        lambda *a, **kw: orig(*a, compute_dtype=jnp.float32,
                                              **kw))


@pytest.mark.parametrize("use_ripple", [True, False], ids=["ripple", "dense"])
def test_euler_trajectory_matches_the_jax_launcher(tree, monkeypatch,
                                                   use_ripple):
    """Both launchers' samplers, 12 Euler rectified-flow steps in float32
    on the same params, noise and text embedding with a zero ``vec`` (the
    JAX one jitted, its model pinned to f32 as the port's
    ``compute_dtype``); with ripple, steps 10 snaps."""
    _j_f32(monkeypatch)
    shape = serve_lib.serving_shape(ARCH, "gen_1024", smoke=True,
                                    steps=STEPS)
    j_shape = serve_lib.serving_shape(J_ARCH, "gen_1024", smoke=True,
                                      steps=STEPS)
    j_fn, lat_shape = j_serve.build_sampler(
        J_ARCH, j_shape, jax.tree_util.tree_map(jnp.asarray, tree),
        use_ripple=use_ripple)
    fn, t_lat_shape = serve_lib.build_sampler(
        ARCH, shape, params_from_numpy(tree, ARCH.model, device="cpu"),
        use_ripple=use_ripple, compute_dtype=torch.float32)
    assert tuple(lat_shape) == tuple(t_lat_shape) == (8, 8, 4)
    lat, _, txt, _ = _inputs(3)
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
    want = np.asarray(j_fn(jnp.asarray(lat), jnp.asarray(txt), rngs))
    got = fn(torch.from_numpy(lat), torch.from_numpy(txt)).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, lat) > 0.1  # the trajectory moved
    assert _rel(got, want) < 1e-3, _rel(got, want)


def test_streamed_and_resumed_equal_the_monolithic_run():
    """Streamed every 4 steps, the last chunk is the monolithic run bit for
    bit; resumed from the step-4 ``__ckpt__`` (x_t as the noise), the
    remaining chunks are the uninterrupted run's."""
    shape = serve_lib.serving_shape(ARCH, "gen_1024", smoke=True,
                                    steps=STEPS)
    model = init_mmdit(ARCH.model, seed=1, device="cpu", zero_init=False)
    mono, lat = serve_lib.build_sampler(ARCH, shape, model,
                                        compute_dtype=torch.float32)
    stream, _ = serve_lib.build_sampler(ARCH, shape, model, stream_every=4,
                                        compute_dtype=torch.float32)
    noise = torch.stack([request_noise(s, lat, "cpu") for s in (1, 2)])
    txt = torch.from_numpy(_inputs(5)[2])
    whole = list(stream(noise, txt, [1, 2]))
    assert [aux["__ckpt__"]["step"] for _, aux in whole] == [4, 8, 12]
    assert torch.equal(whole[-1][0], mono(noise, txt, [1, 2]))
    ck = whole[0][1]["__ckpt__"]
    assert ck["dstate"] is None  # the cache is threaded for the vdit only
    resumed = list(stream(whole[0][0], txt, [1, 2], resume=ck))
    assert len(resumed) == 2
    for (got, _), (want, _) in zip(resumed, whole[1:]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch_name,smoke", [("flux-dev", False),
                                             ("flux-dev", True)],
                         ids=["gen_1024", "smoke"])
def test_attention_shapes_and_plans_follow_the_reference(arch_name, smoke,
                                                         monkeypatch):
    """The token count and head dim of the joint attention, as the
    reference's ``attention_plan`` asks its dispatch for them; on CUDA
    operands the port plans the fused Δ-check and the ripple kernel."""
    arch = get_smoke_config(arch_name) if smoke else get_config(arch_name)
    j_arch = j_get_smoke(arch_name) if smoke else j_get_config(arch_name)
    shape = serve_lib.serving_shape(arch, "gen_1024", smoke=smoke)
    seen = []
    orig = j_workloads.dispatch_lib.plan_for_shape
    monkeypatch.setattr(j_workloads.dispatch_lib, "plan_for_shape",
                        lambda n, hd, *a, **kw: seen.append((n, hd))
                        or orig(n, hd, *a, **kw))
    j_workloads.attention_plan(j_arch, shape)
    assert attention_shapes(arch, shape) == seen
    assert latent_shape_for(arch, shape) == tuple(
        j_workloads.latent_shape_for(j_arch, shape))
    if not smoke:
        assert seen == [(4608, 128)]
    (n, hd, plan), = serve_lib.attention_plans(arch, shape, on_cuda=True)
    assert (n, hd) == seen[0]
    assert (plan.backend, plan.fused_mask) == ("pallas", True)
    (_, _, cpu), = serve_lib.attention_plans(arch, shape, on_cuda=False)
    assert cpu.backend == "reference"


def _factory5(shape, steps, policy=None, reuse_every=None,
              stream_every=None):
    return lambda noise, txt, seeds: noise


@pytest.mark.parametrize("smoke", [False, True], ids=["gen_1024", "smoke"])
def test_bucket_key_of_a_flux_request_equals_the_reference(smoke):
    arch = get_smoke_config("flux-dev") if smoke else get_config("flux-dev")
    j_arch = j_get_smoke("flux-dev") if smoke else j_get_config("flux-dev")
    shape = serve_lib.serving_shape(arch, "gen_1024", smoke=smoke)
    (_, req), = mixed_request_stream(arch, (shape,), 1, seed=3,
                                     policy="ripple", stream_every=4)
    (_, j_req), = j_workloads.mixed_request_stream(
        j_arch, (shape,), 1, seed=3, policy="ripple", stream_every=4)
    np.testing.assert_array_equal(req.txt, j_req.txt)
    got = DiffusionEngine(_factory5, device="cpu")._bucket_key(req)
    want = j_engine.DiffusionEngine(sampler_factory=_factory5)._bucket_key(
        j_req)
    assert got == tuple(want)
    assert got[0] == ((8, 8, 4) if smoke else (128, 128, 16))
    assert got[5] == ((8, 64) if smoke else (512, 4096))


def test_main_serves_flux_dev_on_cpu(tmp_path, caplog):
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    path = tmp_path / "s.json"
    done = serve_lib.main(["--device", "cpu", "--smoke", "--arch", "flux-dev",
                           "--requests", "2", "--summary-json", str(path)])
    assert [r.request_id for r in done] == [0, 1]
    # Mixed traffic: the base 64² shape, then its half resolution.
    assert [r.latents.shape for r in done] == [(8, 8, 4), (4, 4, 4)]
    for r in done:
        assert np.isfinite(r.latents).all()
    assert "flux-dev-smoke (2 double + 2 single blocks) at gen_1024" \
        in caplog.text
    assert "attention[ripple/reference" in caplog.text
    summary = json.loads(path.read_text())
    assert set(summary) == _reference_summary_keys()
    assert summary["completed"] == summary["submitted"] == [0, 1]


@pytest.mark.parametrize("guidance", [1.0, 4.5])
def test_cfg_wrap_matches_jax(guidance):
    """A toy denoiser whose stacked batch's two halves differ (the first
    half unconditional, the second conditional), through both packages'
    ``cfg_wrap``."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    t = np.array([0.9, 0.5, 0.1], np.float32)
    w = rng.standard_normal((6, 1, 1, 1)).astype(np.float32)

    def toy(mod):
        def f(xx, tt, step):
            return xx * mod.asarray(w) + tt[:, None, None, None] * step
        return f

    class TorchNs:
        asarray = staticmethod(torch.from_numpy)

    want = np.asarray(j_sampler.cfg_wrap(toy(jnp), guidance)(
        jnp.asarray(x), jnp.asarray(t), 3))
    got = cfg_wrap(toy(TorchNs), guidance)(torch.from_numpy(x),
                                           torch.from_numpy(t), 3).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

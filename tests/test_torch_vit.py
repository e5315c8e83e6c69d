"""The port's ViT against the JAX package at the smoke config (32² images,
patch 8: a (1, 4, 4) grid behind the cls token, 17 tokens; 2 layers, 4
heads of 16): the configs and the vision shapes, every parameter leaf
crossing through ``params_from_numpy``, the forward in f32 with ripple
off, on at the Eq. 4 ramp (θ 0 at step 0 of 2) and at a fixed θ 0.2
(entries snap), the snap masks of one layer against ``compute_reuse``,
the classify workload in bf16 against the reference's, and the backend
``auto`` picks at the full model's 197 tokens."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import apply_overrides as j_overrides  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.configs.lm_shapes import VISION_SHAPES as J_SHAPES  # noqa: E402
from repro.core import dispatch as j_dispatch  # noqa: E402
from repro.core.reuse import compute_reuse  # noqa: E402
from repro.core.schedule import axis_thresholds  # noqa: E402
from repro.launch.workloads import build_workload  # noqa: E402
from repro.models.params import ParamDef, param_count  # noqa: E402
from repro.models.vit import vit_apply as j_vit_apply  # noqa: E402
from repro.models.vit import vit_defs  # noqa: E402
from repro_torch.config.base import apply_overrides  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.lm_shapes import VISION_SHAPES  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core import policy as policy_lib  # noqa: E402
from repro_torch.launch.workloads import classify_step  # noqa: E402
from repro_torch.models.params import (init_vit, iter_specs,  # noqa: E402
                                       params_from_numpy, vit_param_specs)
from repro_torch.models.vit import ViT, vit_apply  # noqa: E402

torch.set_num_threads(2)

ARCH = get_smoke_config("vit-l16")
J_ARCH = j_get_smoke("vit-l16")
# The two ripple settings the ViT is held at: the config's schedule
# switched on (θ 0 at step 0: nothing snaps, the snap still runs), and
# the fixed threshold of 0.2 from step 0 (entries snap).
SETTINGS = {
    "off": (),
    "ramp": ("ripple.enabled=true",),
    "fixed": ("ripple.enabled=true", "ripple.i_min=0",
              "ripple.fixed_threshold=0.2"),
}


def _key(k):
    return getattr(k, "key", getattr(k, "idx", k))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def tree():
    """The JAX param tree with every leaf redrawn from a seeded numpy
    generator: weights at fan-in scale, norm scales around 1, biases
    small but non-zero."""
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        shape = leaf.shape
        if len(shape) == 1 or _key(path[-1]) in ("scale", "bias", "b",
                                                  "bi", "bo"):
            base = 1.0 if _key(path[-1]) == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
        # (d_in, d_out) weights, stacked on a layer dim in ``blocks``.
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, vit_defs(J_ARCH.model), is_leaf=lambda x: isinstance(x, ParamDef))


@pytest.fixture(scope="module")
def model(tree):
    return params_from_numpy(tree, ARCH.model, device="cpu")


def _images(batch, res=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, res, res, 3)).astype(np.float32)


def _overridden(name):
    return (apply_overrides(ARCH, SETTINGS[name]).ripple,
            j_overrides(J_ARCH, SETTINGS[name]).ripple)


def test_configs_and_shapes_match_jax():
    for j, t in ((j_get_config("vit-l16"), get_config("vit-l16")),
                 (J_ARCH, ARCH)):
        assert dataclasses.asdict(j.model) == dataclasses.asdict(t.model)
        assert dataclasses.asdict(j.ripple) == dataclasses.asdict(t.ripple)
        assert [dataclasses.asdict(s) for s in j.shapes] == \
            [dataclasses.asdict(s) for s in t.shapes]
        assert (j.name, j.family, j.source) == (t.name, t.family, t.source)
    assert [dataclasses.asdict(s) for s in VISION_SHAPES] == \
        [dataclasses.asdict(s) for s in J_SHAPES]
    full = get_config("vit-l16").ripple
    assert not full.enabled and full.axes == ("x", "y")


@pytest.mark.parametrize("name", ["vit-l16", "efficientnet-b7"])
def test_registry_entries_match_jax(name):
    """Field for field over the port's ``ArchConfig`` (the reference's
    also carries the training and checkpoint settings)."""
    for get, j_get in ((get_config, j_get_config),
                       (get_smoke_config, j_get_smoke)):
        t, j = dataclasses.asdict(get(name)), dataclasses.asdict(j_get(name))
        assert t == {f: j[f] for f in t}


def test_params_from_numpy_covers_every_leaf(tree, model):
    j_paths = {tuple(_key(k) for k in path)
               for path, _ in jax.tree_util.tree_leaves_with_path(tree)}
    t_paths = {path for path, _ in iter_specs(vit_param_specs(ARCH.model))}
    assert j_paths == t_paths
    assert sum(p.numel() for p in model.parameters()) == \
        param_count(vit_defs(J_ARCH.model))
    np.testing.assert_array_equal(model.blocks[1].mlp.wi.numpy(),
                                  tree["blocks"]["mlp"]["wi"][1])
    np.testing.assert_array_equal(model.cls.numpy(), tree["cls"])


def test_full_model_param_count_matches_jax():
    cfg = get_config("vit-l16").model
    meta = ViT(cfg, device="meta")
    n = sum(p.numel() for p in meta.parameters())
    assert n == param_count(vit_defs(j_get_config("vit-l16").model))
    assert 3.0e8 < n < 3.1e8  # ViT-L/16: 304 M


def test_init_vit_zero_init_follows_the_jax_defs():
    m = init_vit(ARCH.model, seed=0, device="cpu")
    assert not m.head.b.any() and (m.ln_f.scale == 1).all()
    assert m.cls.std().item() == pytest.approx(0.02, rel=0.3)
    served = init_vit(ARCH.model, seed=0, device="cpu", zero_init=False)
    assert served.head.b.any() and (served.ln_f.scale != 1).any()


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_forward_matches_jax_f32(tree, model, setting):
    rip, j_rip = _overridden(setting)
    x = _images(2)
    want = np.asarray(j_vit_apply(tree, jnp.asarray(x), J_ARCH.model,
                                  ripple=j_rip, compute_dtype=jnp.float32))
    got = vit_apply(model, torch.from_numpy(x), ARCH.model, ripple=rip,
                    compute_dtype=torch.float32).numpy()
    assert got.shape == (2, ARCH.model.num_classes)
    assert _rel(got, want) < 1e-3


def test_ripple_changes_the_logits_only_when_entries_snap(model):
    x = torch.from_numpy(_images(2))
    out = {s: vit_apply(model, x, ARCH.model, ripple=_overridden(s)[0],
                        compute_dtype=torch.float32) for s in SETTINGS}
    assert torch.equal(out["ramp"], out["off"])
    assert not torch.equal(out["fixed"], out["off"])


@pytest.mark.parametrize("setting", ["ramp", "fixed"])
def test_snap_masks_equal_compute_reuse(model, monkeypatch, setting):
    """The first layer's decision on the port's operands: its masks and
    snapped operands bit-equal to the reference's ``compute_reuse`` on
    the (1, 4, 4) grid tokens (slice (1, 16)); the cls token untouched."""
    rip, j_rip = _overridden(setting)
    seen = []
    pol = policy_lib.get_policy("ripple")  # the instance dispatch resolves
    orig = pol.decide

    def spy(q, k, **kw):
        d = orig(q, k, **kw)
        seen.append((q, k, d, kw["grid"], kw["grid_slice"]))
        return d

    monkeypatch.setattr(pol, "decide", spy)
    vit_apply(model, torch.from_numpy(_images(2)), ARCH.model, ripple=rip,
              compute_dtype=torch.float32)
    assert len(seen) == ARCH.model.num_layers
    q, k, d, grid, gs = seen[0]
    assert grid == (1, 4, 4) and gs == (1, 16) and q.shape[-2] == 17
    thetas = {a: float(v) for a, v in axis_thresholds(j_rip, 0, 2).items()}
    assert d.thetas == {a: (thetas[a] if a in ("x", "y") else 0.0)
                        for a in "txy"}
    snapped = 0
    for x, s, mask in ((q, d.q, d.q_mask), (k, d.k, d.k_mask)):
        ref = compute_reuse(jnp.asarray(x[..., 1:, :].numpy()), grid,
                            d.thetas, axes=("x", "y"))
        np.testing.assert_array_equal(mask[..., 1:, :].numpy(),
                                      np.asarray(ref.mask))
        np.testing.assert_array_equal(s[..., 1:, :].numpy(),
                                      np.asarray(ref.snapped))
        assert not mask[..., 0, :].any() and torch.equal(s[..., 0, :],
                                                         x[..., 0, :])
        snapped += int(mask.sum())
    assert (snapped > 0) == (setting == "fixed")


def test_classify_workload_matches_jax_bf16(tree, model):
    """serve_b1 at 224² (a (1, 28, 28) grid) in bf16: relative L2 within
    3e-2 of the reference's ``build_workload(..., "serve_b1").fn``."""
    x = _images(1, res=224, seed=3)
    wl = build_workload(J_ARCH, "serve_b1", None)
    want = np.asarray(wl.fn(tree, jnp.asarray(x)).astype(jnp.float32))
    fn = classify_step(ARCH, ARCH.shape("serve_b1"), model)
    got = fn(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 10)
    assert _rel(got.float().numpy(), want) < 3e-2


def test_classify_step_checks_its_cell(model):
    fn = classify_step(ARCH, ARCH.shape("serve_b1"), model)
    with pytest.raises(ValueError, match="takes images"):
        fn(torch.zeros(2, 224, 224, 3))
    with pytest.raises(ValueError, match="no classify workload"):
        classify_step(ARCH, ARCH.shape("cls_224"), model)


def test_auto_backend_at_197_tokens_is_reference_in_both(monkeypatch):
    """197 tokens (cls + 14 x 14) are odd, so ``auto`` cannot pick the
    pair kernel on the card (port) or the TPU (reference): the snapped
    operands go to the reference backend; 196 would take the kernel."""
    cfg = _overridden("fixed")[0]
    j_cfg = _overridden("fixed")[1]
    monkeypatch.setattr(j_dispatch, "_platform", lambda: "tpu")
    for n, want in ((197, "reference"), (196, "pallas")):
        assert dispatch.resolve_backend(cfg, None, has_bias=False, n_tokens=n,
                                        on_cuda=True) == want
        assert j_dispatch.resolve_backend(j_cfg, None, has_bias=False,
                                          n_tokens=n) == want
    qk = (128, 16, 197, 64)
    plan = dispatch.resolve_plan(qk, qk, cfg, on_cuda=True)
    assert plan.backend == "reference" and plan.fused_mask
    assert dispatch.resolve_plan(qk, qk, get_config("vit-l16").ripple,
                                 on_cuda=True).backend == "dense"

"""The port's EfficientNet against the JAX package at the smoke config
(64² images, width 0.35, depth 0.35: 10 MBConv blocks) and the B7
config's stage table: the rounding helpers and ``effnet_stages``, every
parameter leaf crossing through ``params_from_numpy`` (depthwise
(k, k, 1, C) leaves as (C, 1, k, k)), the convolution substrate (a
depthwise stride-2 "SAME" convolution, batch-statistics normalization),
the forward in f32, batch statistics making an image's logits depend on
its batch in both packages alike, and the classify workload in bf16
against the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.launch.workloads import build_workload  # noqa: E402
from repro.models import conv as j_conv  # noqa: E402
from repro.models import efficientnet as j_eff  # noqa: E402
from repro.models.params import ParamDef, param_count  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch.workloads import classify_step  # noqa: E402
from repro_torch.models import conv  # noqa: E402
from repro_torch.models import efficientnet as eff  # noqa: E402
from repro_torch.models.params import (effnet_param_specs,  # noqa: E402
                                       init_effnet, iter_specs,
                                       params_from_numpy, to_port)

torch.set_num_threads(2)

ARCH = get_smoke_config("efficientnet-b7")
J_ARCH = j_get_smoke("efficientnet-b7")
# Jitted, as the reference's workloads run it: eager JAX compiles each of
# the net's ops on first use (about 12 s here), one jit about 1 s.
j_effnet_apply = jax.jit(j_eff.effnet_apply, static_argnums=(2,),
                         static_argnames=("compute_dtype",))


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
        if len(shape) == 1:
            base = 1.0 if _key(path[-1]) == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
        fan = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, j_eff.effnet_defs(J_ARCH.model),
        is_leaf=lambda x: isinstance(x, ParamDef))


@pytest.fixture(scope="module")
def model(tree):
    return params_from_numpy(tree, ARCH.model, device="cpu")


def _images(batch, res=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, res, res, 3)).astype(np.float32)


def test_rounding_and_stages_match_jax():
    for c in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
        for w in (0.35, 1.0, 1.1, 2.0):
            assert eff.round_filters(c, w) == j_eff.round_filters(c, w)
    for r in (1, 2, 3, 4):
        for dm in (0.35, 1.0, 3.1):
            assert eff.round_repeats(r, dm) == j_eff.round_repeats(r, dm)
    full, j_full = get_config("efficientnet-b7"), j_get_config("efficientnet-b7")
    for t, j in ((full, j_full), (ARCH, J_ARCH)):
        assert eff.effnet_stages(t.model) == j_eff.effnet_stages(j.model)
    assert sum(s[3] for s in eff.effnet_stages(full.model)) == 55


def test_params_from_numpy_covers_every_leaf(tree, model):
    j_paths = {tuple(_key(k) for k in path)
               for path, _ in jax.tree_util.tree_leaves_with_path(tree)}
    t_paths = {path for path, _ in iter_specs(effnet_param_specs(ARCH.model))}
    assert j_paths == t_paths
    assert sum(p.numel() for p in model.parameters()) == \
        param_count(j_eff.effnet_defs(J_ARCH.model))
    first, later = model.stages[0][0], model.stages[1][0]
    assert first.expand is None and later.expand is not None  # expand 1, 6
    dw = tree["stages"][1][0]["dw"]["w"]  # (k, k, 1, C)
    np.testing.assert_array_equal(later.dw.w.numpy(), dw.transpose(3, 2, 0, 1))
    assert later.dw.groups == dw.shape[-1] and later.project.b is None


def test_full_model_param_count_matches_jax():
    cfg = get_config("efficientnet-b7").model
    n = sum(p.numel() for p in eff.EfficientNet(cfg, device="meta").parameters())
    assert n == param_count(j_eff.effnet_defs(j_get_config("efficientnet-b7").model))
    assert 6.3e7 < n < 6.7e7  # EfficientNet-B7: 66 M


def test_init_effnet_zero_init_follows_the_jax_defs():
    m = init_effnet(ARCH.model, seed=0, device="cpu")
    blk = m.stages[1][0]
    assert not blk.se_reduce.b.any() and (blk.bn1.scale == 1).all()
    k = blk.dw.w.shape[-1]  # a depthwise leaf's fan-in is k * k
    assert blk.dw.w.std().item() == pytest.approx(1 / k, rel=0.1)
    served = init_effnet(ARCH.model, seed=0, device="cpu", zero_init=False)
    assert served.stages[1][0].se_reduce.b.any()


@pytest.mark.parametrize("k,stride,size", [(5, 2, 16), (3, 2, 15), (3, 1, 8)])
def test_depthwise_conv_matches_jax(k, stride, size):
    rng = np.random.default_rng(k + stride)
    c = 12
    x = rng.standard_normal((2, size, size, c)).astype(np.float32)
    w = rng.standard_normal((k, k, 1, c)).astype(np.float32)
    want = np.asarray(j_conv.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x),
                                    stride=stride, depthwise=True))
    layer = conv.Conv(k, c, c, bias=False, depthwise=True)
    with torch.no_grad():
        layer.w.copy_(to_port(torch.from_numpy(w)))
    got = conv.conv2d(layer, torch.from_numpy(x), stride=stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_batchnorm_matches_jax():
    rng = np.random.default_rng(7)
    x = (3.0 + 2.0 * rng.standard_normal((3, 5, 4, 16))).astype(np.float32)
    scale, bias = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    want = np.asarray(j_conv.batchnorm({"scale": jnp.asarray(scale),
                                        "bias": jnp.asarray(bias)},
                                       jnp.asarray(x)))
    bn = conv.Norm(16)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    got = conv.batchnorm(bn, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_forward_matches_jax_f32(tree, model):
    x = _images(2)
    want = np.asarray(j_effnet_apply(tree, jnp.asarray(x), J_ARCH.model,
                                     compute_dtype=jnp.float32))
    got = eff.effnet_apply(model, torch.from_numpy(x), ARCH.model,
                           compute_dtype=torch.float32).numpy()
    assert got.shape == (2, ARCH.model.num_classes)
    assert _rel(got, want) < 1e-3


def test_batch_statistics_make_logits_depend_on_the_batch(tree, model):
    """Image 0's logits alone differ from its logits in a batch of 2 (no
    running statistics), in both packages alike: each case within 1e-3
    of the reference's."""
    x = _images(2, seed=1)
    j_two = np.asarray(j_effnet_apply(tree, jnp.asarray(x), J_ARCH.model,
                                      compute_dtype=jnp.float32))[0]
    j_one = np.asarray(j_effnet_apply(tree, jnp.asarray(x[:1]), J_ARCH.model,
                                      compute_dtype=jnp.float32))[0]
    two = eff.effnet_apply(model, torch.from_numpy(x), ARCH.model,
                           compute_dtype=torch.float32).numpy()[0]
    one = eff.effnet_apply(model, torch.from_numpy(x[:1]), ARCH.model,
                           compute_dtype=torch.float32).numpy()[0]
    assert _rel(one, two) > 1e-2 and _rel(j_one, j_two) > 1e-2
    assert _rel(one, j_one) < 1e-3 and _rel(two, j_two) < 1e-3


def test_classify_workload_matches_jax_bf16(tree, model):
    """serve_b1 at 224² in bf16: relative L2 within 3e-2 of the
    reference's ``build_workload(..., "serve_b1").fn``."""
    x = _images(1, res=224, seed=3)
    wl = build_workload(J_ARCH, "serve_b1", None)
    want = np.asarray(jax.jit(wl.fn)(tree, jnp.asarray(x)).astype(jnp.float32))
    got = classify_step(ARCH, ARCH.shape("serve_b1"), model)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 10)
    assert _rel(got.float().numpy(), want) < 3e-2

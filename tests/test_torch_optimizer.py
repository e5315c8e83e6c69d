"""The port's AdamW and learning-rate schedules against the JAX
package's ``training/optimizer.py``: the same gradients, passed across
through numpy, give the same parameters and moments."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.utils.pytree import tree_global_norm as j_global_norm  # noqa: E402
from repro_torch.config.base import TrainConfig  # noqa: E402
from repro_torch.training import optimizer as t_opt  # noqa: E402
from repro_torch.utils.pytree import tree_global_norm  # noqa: E402

SHAPES = {"a": (7, 5), "b": (5,), "c": {"d": (3, 4, 2), "e": (1,)}}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return (scale * rng.standard_normal(node)).astype(np.float32)

    return draw(SHAPES)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)  # sorted keys: a, b, c/d, c/e


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_lr_schedule_within_one_ulp(schedule):
    kw = dict(learning_rate=3e-4, warmup_steps=10, total_steps=50,
              schedule=schedule)
    j = j_opt.lr_schedule(JTrainConfig(**kw))
    t = t_opt.lr_schedule(TrainConfig(**kw))
    for step in range(0, 61):
        want = np.float32(j(jnp.asarray(step, jnp.int32)))
        got = np.float32(t(step))
        assert abs(got - want) <= np.spacing(want), (step, got, want)


def test_tree_global_norm_matches_jax():
    tree = _tree(0)
    want = float(j_global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = float(tree_global_norm([torch.from_numpy(a) for a in
                                  _leaves(tree)]))
    assert abs(got - want) <= 2e-7 * want
    assert float(tree_global_norm([])) == 0.0


@pytest.mark.parametrize("clip,decay,scale", [
    (1.0, 0.1, 10.0),   # clipping active, decay
    (0.0, 0.1, 1.0),    # no clipping
    (1.0, 0.0, 10.0),   # clipping, no decay
    (0.0, 0.0, 1.0),
], ids=["clip+decay", "decay", "clip", "plain"])
def test_adamw_update_matches_jax(clip, decay, scale):
    """Three steps on the same grads: params, mu, nu, grad_norm and lr
    within 1e-6 relative per leaf (float32 arithmetic in the same op
    order; XLA's CPU pow and sqrt may round by an ulp)."""
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              grad_clip=clip, weight_decay=decay)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    params = _tree(1)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = j_opt.adamw_init(j_params)
    t_params = [torch.from_numpy(a.copy()) for a in _leaves(params)]
    t_state = t_opt.adamw_init(t_params)
    for step in range(3):
        grads = _tree(10 + step, scale)
        j_params, j_state, j_m = j_opt.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params,
            jcfg)
        t_state, t_m = t_opt.adamw_update(
            [torch.from_numpy(a) for a in _leaves(grads)], t_state,
            t_params, tcfg)
        assert t_state.step == int(j_state.step) == step + 1
        for name, got, want in (("params", t_params, j_params),
                                ("mu", t_state.mu, j_state.mu),
                                ("nu", t_state.nu, j_state.nu)):
            for g, w in zip(got, _leaves(want)):
                assert _rel(g.numpy(), w) <= 1e-6, (name, step)
        assert _rel(float(t_m["grad_norm"]), float(j_m["grad_norm"])) <= 1e-6
        assert np.float32(t_m["lr"]) == np.float32(j_m["lr"])
    if clip:
        assert float(t_m["grad_norm"]) > clip  # the clip was active


def test_adamw_keeps_float32_moments_for_bf16_params():
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=1)
    p = [torch.ones(4, dtype=torch.bfloat16)]
    state = t_opt.adamw_init(p)
    assert state.mu[0].dtype == torch.float32
    state, _ = t_opt.adamw_update([torch.ones(4)], state, p, cfg)
    assert p[0].dtype == torch.bfloat16 and float(p[0][0]) < 1.0


def test_update_is_in_place():
    cfg = dataclasses.replace(TrainConfig(), warmup_steps=1)
    p = [torch.ones(3)]
    ptr = p[0].data_ptr()
    t_opt.adamw_update([torch.ones(3)], t_opt.adamw_init(p), p, cfg)
    assert p[0].data_ptr() == ptr and float(p[0][0]) != 1.0

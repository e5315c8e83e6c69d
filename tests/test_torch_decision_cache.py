"""The port's cross-step decision cache against its own per-step path and
against the JAX package's cache, at smoke sizes on the CPU.

Within the port (the cases of ``tests/test_decision_cache.py``):
``reuse_every=1`` equals the per-step path bitwise; ``reuse_every>1`` on
unchanged operands under a step-invariant schedule equals ``reuse_every=1``
bitwise; drift past ``drift_tol`` and the final step refresh; the state
threads through the vDiT and the sampler.
Against JAX (same numpy inputs): the refresh decisions, the hit and
refresh counters, the svg plan, the state's fields, a 2-layer vDiT
trajectory under ``reuse_every=2``, the ``equal_mse`` θ and calibration.
The launcher and the engine under the cache are in ``test_torch_serve.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import RippleConfig as JRippleConfig  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core import calibrate as j_calibrate  # noqa: E402
from repro.core import decision_cache as j_dc  # noqa: E402
from repro.core.dispatch import attention_dispatch as j_dispatch  # noqa: E402
from repro.core.policy import EqualMSEPolicy as JEqualMSE  # noqa: E402
from repro.diffusion.sampler import ddim_sample as j_ddim  # noqa: E402
from repro.diffusion.schedule import DDPMSchedule as JDDPM  # noqa: E402
from repro.launch.workloads import \
    vdit_decision_state as j_vdit_decision_state  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.models.vdit import vdit_apply as j_vdit_apply  # noqa: E402
from repro.models.vdit import vdit_defs  # noqa: E402
from repro_torch.config.base import RippleConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import calibrate  # noqa: E402
from repro_torch.core import decision_cache as dc  # noqa: E402
from repro_torch.core.dispatch import attention_dispatch  # noqa: E402
from repro_torch.core.policy import (EqualMSEPolicy, ReuseDecision,  # noqa: E402
                                     ReusePolicy, replay_snap)
from repro_torch.diffusion.sampler import ddim_sample  # noqa: E402
from repro_torch.diffusion.schedule import DDPMSchedule  # noqa: E402
from repro_torch.launch.workloads import vdit_decision_state  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

torch.set_num_threads(2)

GRID = (4, 4, 6)
N = GRID[0] * GRID[1] * GRID[2]
D = 16
KW = dict(enabled=True, theta_min=0.2, theta_max=0.5, i_min=2, i_max=6)
CFG = RippleConfig(**KW)
J_CFG = JRippleConfig(**KW)
# A fixed θ over an all-active range makes decide() independent of the
# step, so cadences differ only in which branch made the operands.
CONST = dict(fixed_threshold=0.35, i_min=0, i_max=1, theta_min=0.35,
             theta_max=0.35)


def _np_qkv(seed=0, shape=(2, 3, N, D)):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _qkv(seed=0, shape=(2, 3, N, D)):
    return tuple(torch.from_numpy(a) for a in _np_qkv(seed, shape))


def _scan(q, k, v, cfg, policy=None, steps=8, total_steps=None):
    """A denoising-shaped loop carrying the cache; (outs, final state)."""
    total = total_steps if total_steps is not None else steps + 2
    cache, outs = None, []
    for si in range(steps):
        out, cache = attention_dispatch(q, k, v, grid=GRID, cfg=cfg, step=si,
                                        total_steps=total, policy=policy,
                                        cached_decision=cache,
                                        return_decision=True)
        outs.append(out)
    return torch.stack(outs), cache


def _j_scan(q, k, v, cfg, policy=None, steps=8, total_steps=None):
    """The same loop through the JAX package, eagerly."""
    total = total_steps if total_steps is not None else steps + 2
    q, k, v = (jnp.asarray(a) for a in (q, k, v))
    cache, outs = None, []
    for si in range(steps):
        out, cache = j_dispatch(q, k, v, grid=GRID, cfg=cfg,
                                step=jnp.asarray(si), total_steps=total,
                                policy=policy, cached_decision=cache,
                                return_decision=True)
        outs.append(np.asarray(out))
    return np.stack(outs), cache


class TestRefreshEveryStep:
    """R=1: the cache passes through, bitwise equal to the per-step path."""

    @pytest.mark.parametrize("policy", ["ripple", "svg", "equal_mse"])
    def test_bitwise_identical_to_per_step_path(self, policy):
        q, k, v = _qkv(0)
        cfg = dataclasses.replace(CFG, reuse_every=1)
        outs, final = _scan(q, k, v, cfg, policy=policy, steps=6)
        for si in range(6):
            ref = attention_dispatch(q, k, v, grid=GRID, cfg=CFG, step=si,
                                     total_steps=8, policy=policy)
            assert torch.equal(outs[si], ref)
        assert int(final.refreshes.max()) == 6
        assert int(final.hits.max()) == 0

    def test_single_call_return_decision_matches_plain(self):
        q, k, v = _qkv(1)
        ref = attention_dispatch(q, k, v, grid=GRID, cfg=CFG, step=5,
                                 total_steps=10)
        out, cache = attention_dispatch(q, k, v, grid=GRID, cfg=CFG, step=5,
                                        total_steps=10, return_decision=True)
        assert torch.equal(out, ref)
        assert cache.q_idx.dtype == torch.int32
        assert cache.q_idx.shape == q.shape


class TestCadence:
    """R>1 with unchanged operands reproduces the R=1 trajectory."""

    @pytest.mark.parametrize("policy", ["ripple", "svg"])
    @pytest.mark.parametrize("every", [2, 4])
    def test_hits_bitwise_equal_to_refreshes(self, policy, every):
        q, k, v = _qkv(2)
        cfg1 = RippleConfig(**{**KW, **CONST}, reuse_every=1)
        cfgR = RippleConfig(**{**KW, **CONST}, reuse_every=every)
        outs1, _ = _scan(q, k, v, cfg1, policy=policy, steps=6)
        outsR, finR = _scan(q, k, v, cfgR, policy=policy, steps=6)
        assert torch.equal(outsR, outs1)
        expected = len([s for s in range(6) if s % every == 0 or s == 7])
        assert int(finR.refreshes.max()) == expected
        assert int(finR.hits.max()) == 6 - expected

    def test_hit_counters_per_cell(self):
        q, k, v = _qkv(3)
        cfg = RippleConfig(**{**KW, **CONST}, reuse_every=4)
        _, fin = _scan(q, k, v, cfg, steps=4, total_steps=10)
        assert fin.refreshes.tolist() == [[1, 1, 1]] * 2
        assert fin.hits.tolist() == [[3, 3, 3]] * 2

    def test_final_step_always_refreshes(self):
        q, k, v = _qkv(4)
        cfg = dataclasses.replace(CFG, reuse_every=8)
        outs, fin = _scan(q, k, v, cfg, steps=6, total_steps=6)
        assert int(fin.refreshes.max()) == 2
        last = attention_dispatch(q, k, v, grid=GRID, cfg=CFG, step=5,
                                  total_steps=6)
        assert torch.equal(outs[5], last)


class TestDrift:
    def test_perturbation_past_bound_forces_refresh(self):
        q, k, v = _qkv(5)
        cfg = dataclasses.replace(CFG, reuse_every=8, drift_tol=0.05)
        _, c0 = attention_dispatch(q, k, v, grid=GRID, cfg=cfg, step=0,
                                   total_steps=10, return_decision=True)
        _, c1 = attention_dispatch(q, k, v, grid=GRID, cfg=cfg, step=1,
                                   total_steps=10, cached_decision=c0)
        assert int(c1.hits.sum()) > 0
        assert torch.equal(c1.refreshes, c0.refreshes)
        qp = 3.0 * q
        out, c2 = attention_dispatch(qp, k, v, grid=GRID, cfg=cfg, step=2,
                                     total_steps=10, cached_decision=c1)
        assert bool((c2.refreshes == c1.refreshes + 1).all())
        ref, _ = attention_dispatch(qp, k, v, grid=GRID, cfg=cfg, step=2,
                                    total_steps=10, return_decision=True)
        assert torch.equal(out, ref)

    def test_drift_off_never_early_refreshes(self):
        q, k, v = _qkv(6)
        cfg = dataclasses.replace(CFG, reuse_every=8, drift_tol=0.0)
        _, c0 = attention_dispatch(q, k, v, grid=GRID, cfg=cfg, step=0,
                                   total_steps=10, return_decision=True)
        _, c1 = attention_dispatch(3.0 * q, k, v, grid=GRID, cfg=cfg, step=1,
                                   total_steps=10, cached_decision=c0)
        assert torch.equal(c1.refreshes, c0.refreshes)


class TestGating:
    def test_dense_policy_rejects_cache(self):
        q, k, v = _qkv(7)
        with pytest.raises(ValueError, match="decision caching"):
            attention_dispatch(q, k, v, grid=GRID, cfg=CFG, step=0,
                               total_steps=10, policy="dense",
                               return_decision=True)

    def test_external_bias_rejected(self):
        q, k, v = _qkv(7)
        with pytest.raises(ValueError, match="bias"):
            attention_dispatch(q, k, v, grid=GRID, cfg=CFG, step=0,
                               total_steps=10, bias=torch.zeros(1, 1, N, N),
                               return_decision=True)

    def test_missing_step_rejected(self):
        q, k, v = _qkv(7)
        with pytest.raises(ValueError, match="concrete step"):
            attention_dispatch(q, k, v, grid=GRID, cfg=CFG,
                               thetas={"t": 0.2, "x": 0.2, "y": 0.2},
                               return_decision=True)

    def test_legacy_policy_without_capability_rejected(self):
        class _Legacy(ReusePolicy):
            name = "legacy_nocache_test"

            def decide(self, q, k, *, grid, cfg, thetas, bias=None,
                       grid_slice=None, fused=False):
                return ReuseDecision(q=q, k=k, thetas=thetas,
                                     savings=torch.zeros(()))

        assert not dc.supports_cache(CFG, _Legacy())
        q, k, v = _qkv(7)
        with pytest.raises(ValueError, match="decision caching"):
            attention_dispatch(q, k, v, grid=GRID, cfg=CFG, step=0,
                               total_steps=10, policy=_Legacy(),
                               return_decision=True)
        out = attention_dispatch(q, k, v, grid=GRID, cfg=CFG, step=0,
                                 total_steps=10, policy=_Legacy())
        assert torch.isfinite(out).all()

    def test_supports_cache_matrix(self):
        for pol in ("ripple", "svg", "equal_mse", "dense"):
            assert dc.supports_cache(CFG, pol) == j_dc.supports_cache(J_CFG,
                                                                      pol)
        assert dc.supports_cache(CFG, "equal_mse")
        assert not dc.supports_cache(CFG, "dense")
        assert not dc.supports_cache(RippleConfig(), "ripple")


class TestAgainstJax:
    """The same numpy operands through both packages' caches."""

    @pytest.mark.parametrize("every,drift", [(1, 0.0), (3, 0.0), (4, 0.0),
                                             (4, 0.05), (8, 0.5)])
    def test_refresh_due_matches_jax(self, every, drift):
        rng = np.random.default_rng(every)
        ref = rng.uniform(0.5, 1.5, (2, 3)).astype(np.float32)
        moved = ref.copy()
        moved[1, 2] *= 1.2          # past 0.05, within 0.5
        stats = {"same": ref, "moved": moved, "far": 3.0 * ref}
        kw = dict(reuse_every=every, drift_tol=drift)
        cfg, j_cfg = RippleConfig(**KW, **kw), JRippleConfig(**KW, **kw)
        for total in (None, 10):
            for step in range(12):
                for stat in stats.values():
                    want = bool(j_dc.refresh_due(
                        step, j_cfg, jnp.asarray(stat), jnp.asarray(ref),
                        total))
                    got = dc.refresh_due(step, cfg, torch.from_numpy(stat),
                                         torch.from_numpy(ref), total)
                    assert got == want, (step, total, stat)

    def test_drift_stat_matches_jax(self):
        q, k, _ = _np_qkv(8)
        got = dc.drift_stat(torch.from_numpy(q), torch.from_numpy(k), CFG)
        want = np.asarray(j_dc.drift_stat(jnp.asarray(q), jnp.asarray(k),
                                          J_CFG))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)

    @pytest.mark.parametrize("policy", ["ripple", "svg"])
    def test_counters_and_outputs_match_jax(self, policy):
        q, k, v = _np_qkv(9)
        kw = dict(reuse_every=3, i_min=1)
        cfg = RippleConfig(**{**KW, **kw})
        j_cfg = JRippleConfig(**{**KW, **kw})
        outs, fin = _scan(*(torch.from_numpy(a) for a in (q, k, v)), cfg,
                          policy=policy, steps=8, total_steps=8)
        j_outs, j_fin = _j_scan(q, k, v, j_cfg, policy=policy, steps=8,
                                total_steps=8)
        np.testing.assert_array_equal(fin.hits.numpy(), np.asarray(j_fin.hits))
        np.testing.assert_array_equal(fin.refreshes.numpy(),
                                      np.asarray(j_fin.refreshes))
        np.testing.assert_allclose(outs.numpy(), j_outs, rtol=1e-4,
                                   atol=1e-5)
        if policy == "ripple":
            np.testing.assert_array_equal(fin.q_idx.numpy(),
                                          np.asarray(j_fin.q_idx))
            np.testing.assert_array_equal(fin.k_idx.numpy(),
                                          np.asarray(j_fin.k_idx))

    def test_drift_refreshes_match_jax(self):
        """Operands that move each step past the guard's bound on some
        steps: the refresh counters agree with the JAX cache's."""
        q, k, v = _np_qkv(10)
        kw = dict(reuse_every=8, drift_tol=0.1, i_min=1)
        cfg, j_cfg = RippleConfig(**{**KW, **kw}), JRippleConfig(**{**KW, **kw})
        cache = j_cache = None
        for step, amp in enumerate((1.0, 1.01, 1.5, 1.52, 1.53, 2.5, 2.5)):
            qs = (amp * q).astype(np.float32)
            _, cache = attention_dispatch(
                torch.from_numpy(qs), torch.from_numpy(k),
                torch.from_numpy(v), grid=GRID, cfg=cfg, step=step,
                total_steps=10, cached_decision=cache, return_decision=True)
            _, j_cache = j_dispatch(
                jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), grid=GRID,
                cfg=j_cfg, step=jnp.asarray(step), total_steps=10,
                cached_decision=j_cache, return_decision=True)
            np.testing.assert_array_equal(cache.refreshes.numpy(),
                                          np.asarray(j_cache.refreshes))
            np.testing.assert_array_equal(cache.hits.numpy(),
                                          np.asarray(j_cache.hits))
        assert int(cache.refreshes.max()) == 3  # steps 0, 2 and 5

    def test_svg_plan_bit_equal_to_jax(self):
        q, k, v = _np_qkv(11)
        cfg = dataclasses.replace(CFG, reuse_every=2)
        j_cfg = dataclasses.replace(J_CFG, reuse_every=2)
        _, cache = attention_dispatch(
            *(torch.from_numpy(a) for a in (q, k, v)), grid=GRID, cfg=cfg,
            step=0, total_steps=4, policy="svg", return_decision=True)
        _, j_cache = j_dispatch(
            *(jnp.asarray(a) for a in (q, k, v)), grid=GRID, cfg=j_cfg,
            step=jnp.asarray(0), total_steps=4, policy="svg",
            return_decision=True)
        np.testing.assert_array_equal(cache.bias.numpy(),
                                      np.asarray(j_cache.bias))
        np.testing.assert_array_equal(cache.block_map.numpy(),
                                      np.asarray(j_cache.block_map))
        assert cache.q_idx is None and j_cache.q_idx is None


def test_replay_snap_passes_text_tokens_through():
    """A hit gathers the grid segment by the cached map; text tokens are
    untouched and never masked."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 3, 5 + N, D))
                         .astype(np.float32))
    cfg = RippleConfig(**{**KW, **CONST})
    from repro_torch.core.policy import snap_operand

    s, m, src = snap_operand(x, True, GRID, {a: 0.35 for a in "txy"}, cfg,
                             ("t", "x", "y"), (5, N), False, want_src=True)
    assert src.shape == (2, 3, N, D) and src.dtype == torch.int32
    s2, m2 = replay_snap(x, src, (5, N), True)
    assert torch.equal(s2, s) and torch.equal(m2, m)
    assert not m2[..., :5, :].any()
    assert m2.any()


def test_state_arrays_round_trip_and_slicing():
    q, k, v = _qkv(13)
    cfg = dataclasses.replace(CFG, reuse_every=2)
    _, c = attention_dispatch(q, k, v, grid=GRID, cfg=cfg, step=3,
                              total_steps=6, return_decision=True)
    arrays = dc.state_to_arrays(c)
    back = dc.state_from_arrays(arrays)
    for name, a in arrays.items():
        got = getattr(back, name)
        assert (got is None) == (a is None)
        if a is not None:
            assert torch.equal(got, getattr(c, name))
    with pytest.raises(ValueError, match="unknown"):
        dc.state_from_arrays({**arrays, "bogus": None})
    stacked = dc.stack_layers([c, c])
    parts = [dc.slice_state(stacked, i) for i in range(2)]
    merged = dc.merge_states(parts)
    for name in ("q_idx", "k_idx", "ref_stat", "hits", "refreshes"):
        assert torch.equal(getattr(merged, name), getattr(stacked, name))
    with pytest.raises(ValueError, match="disagree"):
        dc.merge_states([parts[0], dataclasses.replace(parts[1],
                                                       q_idx=None)])


class TestEqualMSEAndCalibration:
    @pytest.mark.parametrize("slope", [-0.15, -0.4, -0.835, 0.3])
    def test_equal_mse_theta_within_one_ulp_of_jax(self, slope):
        cfg = RippleConfig(**KW)
        pol, j_pol = EqualMSEPolicy(mse_slope=slope), JEqualMSE(mse_slope=slope)
        for step in range(24):
            got = np.float32(pol.thetas_for(cfg, step, 12)["t"])
            want = np.float32(j_pol.thetas_for(J_CFG, jnp.asarray(step),
                                               12)["t"])
            ulp = np.abs(got.view(np.int32).astype(np.int64)
                         - want.view(np.int32).astype(np.int64))
            assert ulp <= 1, (step, got, want)

    def test_equal_mse_table_bit_equal_to_jax(self):
        table = np.float32([0.21, 0.27, 0.33, 0.41])
        pol = EqualMSEPolicy.from_schedule(table, i_min=2)
        j_pol = JEqualMSE.from_schedule(table, i_min=2)
        for step in range(10):
            got = np.float32(pol.thetas_for(CFG, step, 10)["x"])
            want = np.asarray(j_pol.thetas_for(J_CFG, jnp.asarray(step),
                                               10)["x"])
            assert got.tobytes() == want.astype(np.float32).tobytes()

    def test_calibrate_threshold_matches_jax(self):
        rng = np.random.default_rng(14)
        base = rng.standard_normal((1, 2, 1, D))
        q, k = ((base + 0.3 * rng.standard_normal((1, 2, N, D)))
                .astype(np.float32) for _ in range(2))
        kw = dict(iters=12, tol=1e-4)
        got = calibrate.calibrate_threshold(torch.from_numpy(q),
                                            torch.from_numpy(k), GRID, CFG,
                                            0.5, **kw)
        want = j_calibrate.calibrate_threshold(jnp.asarray(q),
                                               jnp.asarray(k), GRID, J_CFG,
                                               0.5, **kw)
        assert abs(got - want) <= 4.0 / 2 ** kw["iters"]
        assert EqualMSEPolicy().calibrate(
            torch.from_numpy(q), torch.from_numpy(k), GRID, CFG, 0.5) == {
                "fixed_threshold": calibrate.calibrate_threshold(
                    torch.from_numpy(q), torch.from_numpy(k), GRID, CFG,
                    0.5)}

    def test_step_sensitivity_and_schedule_match_jax(self):
        steps = np.arange(2, 9)
        mses = 1e-3 * np.exp(-0.2 * steps) * (1 + 0.01 * np.sin(steps))
        fit = calibrate.fit_step_sensitivity(steps, mses)
        assert fit == j_calibrate.fit_step_sensitivity(steps, mses)

        def mse(theta, i):
            return theta ** 2 * np.exp(fit["slope"] * i)

        np.testing.assert_array_equal(
            calibrate.equal_mse_schedule(fit, mse, 2, 8, 0.2),
            j_calibrate.equal_mse_schedule(fit, mse, 2, 8, 0.2))


# --- the vDiT, the sampler, the launcher and the engine ---------------------

J_ARCH = dataclasses.replace(
    j_smoke_config("vdit-paper"),
    ripple=dataclasses.replace(j_smoke_config("vdit-paper").ripple,
                               i_min=1, i_max=3))
T_ARCH = dataclasses.replace(
    get_smoke_config("vdit-paper"),
    ripple=dataclasses.replace(get_smoke_config("vdit-paper").ripple,
                               i_min=1, i_max=3))
STEPS = 6  # R=2: refreshes 0, 2, 4, 5; hits 1 and 3, step 3 replays snaps


@pytest.fixture(scope="module")
def tree():
    """The JAX vDiT param tree, every leaf redrawn with numpy."""
    params = init_params(vdit_defs(J_ARCH.model), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        a = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        per_layer = a.shape[1:] if "blocks" in name else a.shape
        x = rng.standard_normal(a.shape) / np.sqrt(per_layer[0]
                                                   if per_layer else 1)
        if "norm" in name:
            x = 1.0 + 0.1 * rng.standard_normal(a.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _inputs(seed, B=1):
    rng = np.random.default_rng(seed)
    m = J_ARCH.model
    lat = rng.standard_normal((B, 4, 8, 8, m.in_channels)).astype(np.float32)
    txt = (0.05 * rng.standard_normal((B, m.txt_tokens, m.txt_dim))).astype(
        np.float32)
    return lat, txt


def test_vdit_refresh_step_matches_plain_and_state_fields_match_jax(tree):
    lat, txt = _inputs(1, B=2)
    model = params_from_numpy(tree, T_ARCH.model, device="cpu")
    rip = dataclasses.replace(T_ARCH.ripple, reuse_every=2)
    args = (torch.from_numpy(lat), torch.full((2,), 500.0),
            torch.from_numpy(txt))
    kw = dict(ripple=rip, step=2, total_steps=4, compute_dtype=torch.float32)
    plain = model(*args, **kw)
    st = vdit_decision_state(T_ARCH, 64, 2)
    assert st == [None] * T_ARCH.model.num_layers
    out, st2 = model(*args, decision_state=st, **kw)
    assert torch.equal(out, plain)
    stacked = dc.stack_layers(st2)
    assert int(stacked.refreshes.sum()) > 0

    j_rip = dataclasses.replace(J_ARCH.ripple, reuse_every=2)
    j_st = j_vdit_decision_state(J_ARCH, 64, 2, compute_dtype=jnp.float32)
    _, j_st2 = j_vdit_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                            jnp.asarray(lat), jnp.full((2,), 500.0),
                            jnp.asarray(txt), J_ARCH.model, ripple=j_rip,
                            step=2, total_steps=4, compute_dtype=jnp.float32,
                            decision_state=j_st)
    got, want = dc.state_to_arrays(stacked), j_dc.state_to_arrays(j_st2)
    assert list(got) == list(want)
    for name in want:
        if want[name] is None:
            assert got[name] is None, name
        else:
            assert got[name].shape == want[name].shape, name
            assert got[name].dtype == want[name].dtype, name
    for name in ("q_idx", "k_idx", "hits", "refreshes"):
        np.testing.assert_array_equal(got[name], want[name])


def test_vdit_trajectory_under_reuse_every_2_matches_jax(tree):
    """A 2-layer vDiT, 6 DDIM steps at R=2 in f32, from the same noise;
    step 3 replays step 2's snaps.  Tolerance: the f32 summation-order
    gap carried through the trajectory, as without the cache."""
    lat, txt = _inputs(2)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_txt = jnp.asarray(txt)
    j_rip = dataclasses.replace(J_ARCH.ripple, reuse_every=2)

    def j_denoise(x, t, step, st):
        out, st = j_vdit_apply(j_params, x, t, j_txt, J_ARCH.model,
                               ripple=j_rip, step=step, total_steps=STEPS,
                               compute_dtype=jnp.float32, decision_state=st)
        return out.astype(x.dtype), st

    j_st = j_vdit_decision_state(J_ARCH, 64, 1, compute_dtype=jnp.float32)
    want, j_fin = jax.jit(lambda x, st: j_ddim(
        j_denoise, x, JDDPM(), STEPS, decision_state=st))(jnp.asarray(lat),
                                                          j_st)
    want = np.asarray(want)

    model = params_from_numpy(tree, T_ARCH.model, device="cpu")
    t_txt = torch.from_numpy(txt)
    rip = dataclasses.replace(T_ARCH.ripple, reuse_every=2)

    def denoise(x, t, step, st):
        out, st = model(x, t, t_txt, ripple=rip, step=step,
                        total_steps=STEPS, compute_dtype=torch.float32,
                        decision_state=st)
        return out.to(x.dtype), st

    got, fin = ddim_sample(denoise, torch.from_numpy(lat), DDPMSchedule(),
                           STEPS, decision_state=vdit_decision_state(
                               T_ARCH, 64, 1))
    got = got.numpy()
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-3, rel
    stacked = dc.stack_layers(fin)
    np.testing.assert_array_equal(stacked.hits.numpy(),
                                  np.asarray(j_fin.hits))
    np.testing.assert_array_equal(stacked.refreshes.numpy(),
                                  np.asarray(j_fin.refreshes))
    assert int(stacked.hits.max()) == 2 and int(stacked.refreshes.max()) == 4


def test_chunked_cached_sampling_equals_monolithic(tree):
    """step_offset / total_steps chunks chain exactly with the state."""
    lat, txt = _inputs(3)
    model = params_from_numpy(tree, T_ARCH.model, device="cpu")
    t_txt = torch.from_numpy(txt)
    rip = dataclasses.replace(T_ARCH.ripple, reuse_every=2)

    def denoise(x, t, step, st):
        out, st = model(x, t, t_txt, ripple=rip, step=step,
                        total_steps=STEPS, compute_dtype=torch.float32,
                        decision_state=st)
        return out.to(x.dtype), st

    x0 = torch.from_numpy(lat)
    full, fin = ddim_sample(denoise, x0, DDPMSchedule(), STEPS,
                            decision_state=vdit_decision_state(T_ARCH, 64, 1))
    x, st = ddim_sample(denoise, x0, DDPMSchedule(), 3, total_steps=STEPS,
                        decision_state=vdit_decision_state(T_ARCH, 64, 1))
    x, st = ddim_sample(denoise, x, DDPMSchedule(), 3, step_offset=3,
                        total_steps=STEPS, decision_state=st)
    assert torch.equal(full, x)
    for a, b in zip(fin, st):
        assert torch.equal(a.hits, b.hits)
        assert torch.equal(a.refreshes, b.refreshes)


def test_sampler_threads_state_and_counts():
    from repro_torch.launch.serve import build_sampler, serving_shape
    from repro_torch.models.params import init_vdit

    shape = serving_shape(T_ARCH, "gen_512", smoke=True, steps=4)
    model = init_vdit(T_ARCH.model, seed=0, device="cpu", zero_init=False)
    fn, lshape = build_sampler(T_ARCH, shape, model, reuse_every=2,
                               compute_dtype=torch.float32)
    B = 2
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, *lshape)).astype(np.float32))
    txt = torch.zeros((B, T_ARCH.model.txt_tokens, T_ARCH.model.txt_dim))
    lat_out, aux = fn(noise, txt)
    assert lat_out.shape == (B, *lshape)
    # 4 steps at R=2: refresh at 0, 2 and the final step; hit at 1 — per
    # layer per (batch, head) cell
    m = T_ARCH.model
    cells = m.num_layers * B * m.num_heads
    assert (int(aux["cache_hits"]), int(aux["cache_refreshes"])) == \
        (1 * cells, 3 * cells)


def test_mha_attention_caches_grid_self_attention_only(tree):
    """The layer returns ``(out, CachedDecision)`` under the cache and
    refuses it for cross-attention, as the JAX package's layer does."""
    from repro_torch.models.attention import mha_attention

    model = params_from_numpy(tree, T_ARCH.model, device="cpu")
    m = T_ARCH.model
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (1, 4 * 4 * 4, m.d_model)).astype(np.float32))
    kw = dict(n_heads=m.num_heads, head_dim=m.d_model // m.num_heads,
              grid=(4, 4, 4), ripple=T_ARCH.ripple, step=2, total_steps=4)
    plain = mha_attention(model.blocks[0].attn, x, **kw)
    out, cache = mha_attention(model.blocks[0].attn, x, return_decision=True,
                               **kw)
    assert torch.equal(out, plain)
    assert cache.q_idx.shape == (1, m.num_heads, 64, m.d_model // m.num_heads)
    with pytest.raises(ValueError, match="cross-attention"):
        mha_attention(model.blocks[0].attn, x, encoder_out=x,
                      cached_decision=cache, **kw)

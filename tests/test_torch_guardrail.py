"""The port's guardrails against the JAX package's, on the CPU: the
sentinels on the same numpy inputs, the degradation ladder's state
sequence on seeded event sequences, the fault grammar and its counts,
the ``attn_nan`` hook in dispatch, the samplers' sentinel readings
against the JAX launcher's on the smoke vDiT, the engine's escalation
chain (degrade, stickiness and re-promotion, the dense floor, the
watchdog, retries, bisection), the launcher's guardrail flags, and the
locks on the caches that router replicas share."""

import os
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import decision_cache as j_dc  # noqa: E402
from repro.core import guardrail as j_guard  # noqa: E402
from repro.serving import faults as j_faults  # noqa: E402
from repro_torch.config.base import apply_overrides  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import decision_cache as dc  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core import guardrail  # noqa: E402
from repro_torch.core import patterns  # noqa: E402
from repro_torch.core.guardrail import (DegradationLadder,  # noqa: E402
                                        GuardrailConfig, next_policy)
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models.params import init_vdit  # noqa: E402
from repro_torch.serving import faults as fault_lib  # noqa: E402
from repro_torch.serving.engine import (DiffusionEngine,  # noqa: E402
                                        GenRequest, is_failover_error)


def _txt(val, tokens=1, dim=1):
    return np.full((tokens, dim), float(val), np.float32)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    """No fault plan in either package before and after each test."""
    fault_lib.clear_faults()
    j_faults.clear_faults()
    yield
    fault_lib.clear_faults()
    j_faults.clear_faults()


# ---------------------------------------------------------------------------
# Sentinels on the same numpy inputs
# ---------------------------------------------------------------------------

def _with_bad(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = np.nan
    flat[3::11] = np.inf
    return x


@pytest.mark.parametrize("lead", [None, 0, 2, 3])
def test_nonfinite_count_equals_the_reference(lead):
    x = _with_bad((2, 3, 5, 4), 0)
    want = np.asarray(j_guard.nonfinite_count(jnp.asarray(x), lead_ndim=lead))
    got = guardrail.nonfinite_count(torch.from_numpy(x), lead_ndim=lead)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wrong", [False, True], ids=["dense", "wrong"])
def test_dense_probe_error_equals_the_reference(wrong):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((16, 8)).astype(np.float32)
               for _ in range(3))
    scale = 8 ** -0.5
    p = np.exp((q @ k.T) * scale)
    out = (p / p.sum(-1, keepdims=True)) @ v
    if wrong:
        out = out + rng.standard_normal(out.shape).astype(np.float32)
    want = float(j_guard.dense_probe_error(*map(jnp.asarray, (q, k, v, out)),
                                           scale))
    got = float(guardrail.dense_probe_error(
        *map(torch.from_numpy, (q, k, v, out)), scale))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    assert (got > 0.5) == wrong


@pytest.mark.parametrize("every", [0, 1, 2])
def test_attach_sentinel_equals_the_reference(every):
    """Two calls (steps 0 and 1) accumulate the non-finite count and max
    the probe error exactly as the reference carries them."""
    cfg = types.SimpleNamespace(sentinel_probe_every=every)
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
               for _ in range(3))
    outs = [rng.standard_normal((2, 3, 8, 4)).astype(np.float32),
            _with_bad((2, 3, 8, 4), 3)]
    scale = 4 ** -0.5
    ours, ref = dc.CachedDecision(), j_dc.CachedDecision()
    for step, out in enumerate(outs):
        ref = j_guard.attach_sentinel(ref, jnp.asarray(out),
                                      *map(jnp.asarray, (q, k, v)), scale,
                                      step, cfg)
        ours = guardrail.attach_sentinel(ours, torch.from_numpy(out),
                                         *map(torch.from_numpy, (q, k, v)),
                                         scale, step, cfg)
        np.testing.assert_array_equal(ours.nonfinite.numpy(),
                                      np.asarray(ref.nonfinite))
        np.testing.assert_allclose(ours.probe_err.numpy(),
                                   np.asarray(ref.probe_err), rtol=1e-5,
                                   atol=1e-6)


def test_sentinel_leaves_carry_across_refreshes_and_the_state_helpers():
    """cache_from_decision carries the sentinel leaves of the previous
    state, and stack / slice / merge / arrays keep them."""
    nf = torch.tensor([[1, 2]], dtype=torch.int32)
    pe = torch.tensor([[0.5, 0.25]])
    prev = dc.CachedDecision(hits=torch.zeros_like(nf),
                             refreshes=torch.ones_like(nf), nonfinite=nf,
                             probe_err=pe)
    d = types.SimpleNamespace(q_src=None, k_src=None, bias=None,
                              block_map=None)
    fresh = dc.cache_from_decision(d, torch.zeros(1, 2), prev=prev)
    assert fresh.nonfinite is nf and fresh.probe_err is pe
    stacked = dc.stack_layers([fresh, fresh])
    assert stacked.nonfinite.shape == (2, 1, 2)
    back = dc.merge_states([dc.slice_state(stacked, 0)])
    torch.testing.assert_close(back.probe_err, stacked.probe_err)
    arrays = dc.state_to_arrays(stacked)
    again = dc.state_from_arrays(arrays)
    torch.testing.assert_close(again.nonfinite, stacked.nonfinite)


# ---------------------------------------------------------------------------
# The ladder: the reference's state machine, event by event
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_ladder_sequences_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    cfg = dict(cooldown_batches=int(rng.integers(0, 4)))
    ours = DegradationLadder(GuardrailConfig(**cfg))
    ref = j_guard.DegradationLadder(j_guard.GuardrailConfig(**cfg))
    bases = {"a": "rainfusion", "b": "ripple", "c": None, "d": "static",
             "e": "mystery", "f": "dense"}
    for _ in range(200):
        fam = str(rng.choice(list(bases)))
        op = str(rng.choice(["effective_policy", "trip", "record_clean"]))
        args = (fam,) if op == "record_clean" else (fam, bases[fam])
        assert getattr(ours, op)(*args) == getattr(ref, op)(*args), (op, fam)
        assert ours.degraded(fam) == ref.degraded(fam)
        assert ours.metrics() == ref.metrics()
    for p in ("rainfusion", "static", "svg", "equal_mse", "ripple", "dense",
              None, "mystery"):
        assert next_policy(p) == j_guard.next_policy(p)


def test_next_policy_rungs():
    assert next_policy("rainfusion") == "ripple"
    assert next_policy("static") == "ripple"
    assert next_policy("ripple") == "dense"
    assert next_policy("dense") is None
    assert next_policy("mystery") == "dense"
    assert next_policy(None) == "dense"


def test_trip_steps_down_and_dead_ends_at_dense():
    lad = DegradationLadder()
    assert lad.effective_policy("f", "rainfusion") == ("rainfusion", False)
    assert lad.trip("f", "rainfusion") == "ripple"
    assert lad.effective_policy("f", "rainfusion") == ("ripple", False)
    assert lad.trip("f", "rainfusion") == "dense"
    assert lad.trip("f", "rainfusion") is None
    m = lad.metrics()
    assert m["degraded_count"] == 2 and m["dense_fallbacks"] == 1
    assert m["degraded_buckets"] == 1
    assert lad.degraded("f") and not lad.degraded("other")


def test_cooldown_probe_and_repromotion():
    lad = DegradationLadder(GuardrailConfig(cooldown_batches=2))
    lad.trip("f", "ripple")
    assert lad.effective_policy("f", "ripple") == ("dense", False)
    lad.record_clean("f")
    lad.record_clean("f")
    assert lad.effective_policy("f", "ripple") == ("ripple", True)
    lad.record_clean("f")
    assert lad.metrics()["repromotions"] == 1
    assert not lad.degraded("f")
    assert lad.effective_policy("f", "ripple") == ("ripple", False)


def test_failed_probe_falls_back_and_restarts_cooldown():
    lad = DegradationLadder(GuardrailConfig(cooldown_batches=1))
    lad.trip("f", "ripple")
    lad.record_clean("f")
    assert lad.effective_policy("f", "ripple") == ("ripple", True)
    assert lad.trip("f", "ripple") == "dense"
    m = lad.metrics()
    assert m["failed_probes"] == 1 and m["repromotions"] == 0
    assert lad.effective_policy("f", "ripple") == ("dense", False)


# ---------------------------------------------------------------------------
# The fault grammar and its counts
# ---------------------------------------------------------------------------

SPECS = ["attn_nan:step=1", "seed=7;attn_nan:step=2;raise:count=3,msg=transient"
         ";poison:rid=5", "hang:seconds=0.5;kill_replica:after=2",
         "crash:after=1,wait_ckpt=0", "artifact_corrupt:after=2,count=-1",
         " raise ; poison:rid=x1 ;", ""]
BAD = ["attn_nam:step=1", "hang:seconds", "raise:count=abc", "seed=x",
       "poison:rid"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_equals_the_reference(spec):
    ours, ref = fault_lib.parse_faults(spec), j_faults.parse_faults(spec)
    assert ours.seed == ref.seed
    assert [(s.kind, s.count, s.params) for s in ours.specs] == \
        [(s.kind, s.count, s.params) for s in ref.specs]


@pytest.mark.parametrize("spec", BAD)
def test_malformed_specs_raise_as_the_reference(spec):
    with pytest.raises(Exception) as want:
        j_faults.parse_faults(spec)
    with pytest.raises(want.type):
        fault_lib.parse_faults(spec)


def test_take_counts_equal_the_reference():
    spec = "raise:count=2;poison:rid=1;hang:count=0;kill_replica:after=1"
    ours, ref = fault_lib.parse_faults(spec), j_faults.parse_faults(spec)
    for kind in ["raise", "poison", "hang", "raise", "raise", "poison",
                 "kill_replica", "kill_replica", "crash"]:
        assert (ours.take(kind) is None) == (ref.take(kind) is None), kind
    assert ours.counters() == ref.counters() == {
        "fault_kill_replica": 1, "fault_poison": 2, "fault_raise": 2}


def test_install_clear_and_env(monkeypatch):
    fault_lib.install_faults("hang:seconds=1")
    assert fault_lib.active_faults().spec("hang") is not None
    fault_lib.clear_faults()
    assert fault_lib.active_faults() is None
    assert fault_lib.ENV_VAR == j_faults.ENV_VAR
    monkeypatch.setenv(fault_lib.ENV_VAR, "poison:rid=4")
    assert fault_lib.install_from_env().spec("poison").param("rid") == 4


def test_attn_nan_flips_only_the_armed_step_and_never_dense():
    from repro_torch.config.base import RippleConfig

    out = torch.ones(2, 8)
    assert torch.isfinite(dispatch._inject_attn_nan(out, 1)).all()
    fault_lib.install_faults("attn_nan:step=1")
    assert not torch.isfinite(dispatch._inject_attn_nan(out, 1)).any()
    assert torch.isfinite(dispatch._inject_attn_nan(out, 0)).all()
    assert torch.isfinite(dispatch._inject_attn_nan(out, None)).all()
    assert fault_lib.active_faults().counters() == {"fault_attn_nan": 1}
    q = torch.randn(1, 2, 16, 8)
    cfg = RippleConfig(enabled=True)
    for backend, finite in (("dense", True), ("reference", False),
                            ("collapse", False)):
        got = dispatch.attention_dispatch(q, q, q, grid=(1, 4, 4), cfg=cfg,
                                          step=1, total_steps=3,
                                          backend=backend)
        assert bool(torch.isfinite(got).all()) == finite, backend


# ---------------------------------------------------------------------------
# Sentinels through the samplers, against the JAX launcher
# ---------------------------------------------------------------------------

SCHEDULE = ("ripple.i_min=0", "ripple.i_max=1")
SENTINEL_CASES = {
    "nan": (("model.num_layers=1",), "attn_nan:step=1"),
    "nan-cache": (("model.num_layers=1", "ripple.reuse_every=2"),
                  "attn_nan:step=1"),
    "probe": (("model.num_layers=1", "ripple.reuse_every=2",
               "ripple.sentinel_probe_every=1"), None),
}


@pytest.mark.parametrize("case", sorted(SENTINEL_CASES))
def test_sentinels_match_the_jax_launcher(case, monkeypatch):
    """``build_sampler(sentinel=True)`` in both launchers on the same
    params, noise and text in float32: the non-finite counts are equal
    with ``attn_nan`` armed, and the drift probe agrees within relative
    1e-3."""
    from repro.config.base import apply_overrides as j_apply
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch import serve as j_serve
    from repro.launch import workloads as j_workloads
    from repro.models.params import init_params
    from repro.models.vdit import vdit_defs
    from repro_torch.models.params import params_from_numpy

    overrides, spec = SENTINEL_CASES[case]
    j_arch = j_apply(j_smoke("vdit-paper"), overrides + SCHEDULE)
    arch = apply_overrides(get_smoke_config("vdit-paper"),
                           overrides + SCHEDULE)
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(
            a.shape[-2] if a.ndim > 1 else 1) + (a.ndim == 1)).astype(
                np.float32),
        init_params(vdit_defs(j_arch.model), jax.random.PRNGKey(0)))
    orig = j_workloads.vdit_lib.vdit_apply
    monkeypatch.setattr(j_workloads.vdit_lib, "vdit_apply",
                        lambda *a, **kw: orig(*a, compute_dtype=jnp.float32,
                                              **kw))
    if spec:
        j_faults.install_faults(spec)
        fault_lib.install_faults(spec)
    j_fn, lat = j_serve.build_sampler(
        j_arch, serve_lib.serving_shape(j_arch, "gen_512", smoke=True),
        jax.tree_util.tree_map(jnp.asarray, tree), sentinel=True)
    fn, _ = serve_lib.build_sampler(
        arch, serve_lib.serving_shape(arch, "gen_512", smoke=True),
        params_from_numpy(tree, arch.model, device="cpu"), sentinel=True,
        compute_dtype=torch.float32)
    m = arch.model
    noise = rng.standard_normal((2, *lat)).astype(np.float32)
    txt = (0.05 * rng.standard_normal((2, m.txt_tokens, m.txt_dim))).astype(
        np.float32)
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
    _, j_aux = j_fn(jnp.asarray(noise), jnp.asarray(txt), rngs)
    _, aux = fn(torch.from_numpy(noise), torch.from_numpy(txt))
    assert set(aux) == set(j_aux)
    for key in ("latent_nonfinite", "sentinel_nonfinite", "cache_hits",
                "cache_refreshes"):
        if key in j_aux:
            assert int(aux[key]) == int(j_aux[key]), key
    if spec:
        assert int(aux["latent_nonfinite"]) > 0
    if "sentinel_drift" in j_aux and not spec:
        want = float(j_aux["sentinel_drift"])
        assert want > 0
        assert float(aux["sentinel_drift"]) == pytest.approx(want, rel=1e-3)


# ---------------------------------------------------------------------------
# The engine's escalation chain (the reference's TestEngineEscalation)
# ---------------------------------------------------------------------------

def _nan_unless_dense(healthy=None):
    def factory(shape, steps, policy=None):
        def fn(noise, txt, seeds):
            if policy != "dense" and not (healthy or {}).get("fixed"):
                return torch.full_like(noise, float("nan"))
            return torch.zeros_like(noise)
        return fn
    return factory


def _engine(factory, **kw):
    kw.setdefault("max_batch", 1)
    kw.setdefault("max_wait_s", 0.01)
    return DiffusionEngine(factory, device="cpu", **kw)


def _req(rid, shape=(4,)):
    return GenRequest(request_id=rid, txt=_txt(rid), latent_shape=shape,
                      steps=2)


def _identity(shape, steps):
    return lambda noise, txt, seeds: noise


def test_sentinel_trip_degrades_to_dense_and_completes():
    eng = _engine(_nan_unless_dense(), max_batch=2, guardrail=True)
    eng.start()
    eng.submit(_req(0))
    r = eng.result(0, timeout=30)
    eng.stop()
    assert np.all(np.isfinite(r.latents)) and r.degraded is True
    m = eng.metrics()
    assert m["degraded_count"] == 1 and m["dense_fallbacks"] == 1


def test_degradation_is_sticky_then_repromotes():
    healthy = {}
    eng = _engine(_nan_unless_dense(healthy),
                  guardrail=GuardrailConfig(cooldown_batches=2))
    eng.start()
    for rid in range(4):
        eng.submit(_req(rid))
        r = eng.result(rid, timeout=30)
        assert np.all(np.isfinite(r.latents)) and r.degraded
    healthy["fixed"] = True
    eng.submit(_req(4))
    assert eng.result(4, timeout=30).degraded is False
    eng.submit(_req(5))
    r = eng.result(5, timeout=30)
    eng.stop()
    assert r.degraded is False
    m = eng.metrics()
    assert m["degraded_count"] == 1
    assert m["repromotions"] == 1 and m["failed_probes"] == 1


def test_dense_floor_failure_errors_not_loops():
    def factory(shape, steps, policy=None):
        return lambda noise, txt, seeds: torch.full_like(noise, float("nan"))

    eng = _engine(factory, guardrail=True)
    eng.start()
    eng.submit(_req(0))
    with pytest.raises(RuntimeError, match="dense floor"):
        eng.result(0, timeout=30)
    eng.stop()


def test_guardrail_requires_policy_aware_factory():
    with pytest.raises(ValueError, match="policy"):
        _engine(_identity, guardrail=True)
    with pytest.raises(ValueError, match="guardrail"):
        _engine(_nan_unless_dense(), guardrail="yes")


def test_hang_fault_trips_watchdog_and_marks_unhealthy():
    fault_lib.install_faults("hang:seconds=1")
    eng = _engine(_identity, batch_timeout_s=0.1)
    eng.start()
    eng.submit(_req(0))
    eng.submit(_req(1))
    with pytest.raises(RuntimeError, match="watchdog") as ei:
        eng.result(0, timeout=30)
    assert is_failover_error(ei.value)
    with pytest.raises(RuntimeError, match="engine stopped"):
        eng.result(1, timeout=30)
    assert eng.healthy() is False
    assert eng.metrics()["watchdog_trips"] == 1
    eng.stop()


def test_transient_raise_fault_is_retried():
    fault_lib.install_faults("raise:count=1,msg=flaky-worker")
    eng = _engine(_identity, max_retries=1, retry_backoff_s=0.01)
    eng.start()
    eng.submit(_req(0, (2,)))
    r = eng.result(0, timeout=30)
    eng.stop()
    assert r.latents.shape == (2,)
    assert eng.metrics()["batch_retries"] == 1


def test_poison_request_quarantined_alone_by_bisection():
    fault_lib.install_faults("poison:rid=2")
    eng = _engine(_identity, max_batch=4, max_wait_s=0.05, max_retries=0,
                  retry_backoff_s=0.01)
    for rid in range(3):
        eng.submit(_req(rid, (2,)))
    eng.start()
    for rid in (0, 1):
        assert eng.result(rid, timeout=30).latents.shape == (2,)
    with pytest.raises(RuntimeError, match="poison"):
        eng.result(2, timeout=30)
    eng.stop()
    assert eng.metrics()["quarantined"] == 1


def test_streamed_nan_chunk_is_caught_before_it_is_published():
    def factory(shape, steps, policy=None, reuse_every=None,
                stream_every=None):
        def gen_fn(noise, txt, seeds):
            yield noise + 1, None
            bad = policy != "dense"
            yield (torch.full_like(noise, float("nan")) if bad
                   else noise + 2), None
        return gen_fn

    eng = _engine(factory, guardrail=True)
    eng.submit(GenRequest(request_id=0, txt=_txt(0), latent_shape=(3,),
                          steps=2, stream_every=1))
    eng.start()
    chunks = list(eng.stream(0, timeout=30))
    r = eng.result(0, timeout=30)
    eng.stop()
    assert len(chunks) == 2 and all(np.isfinite(c).all() for c in chunks)
    np.testing.assert_array_equal(chunks[-1], r.latents)
    assert r.degraded


def test_artifact_corrupt_fault_fires_after_a_served_batch(tmp_path,
                                                         monkeypatch):
    """``artifact_corrupt:after=1``: after the first served batch the
    engine loop overwrites the artifact file and drops the install, so
    the next load takes the warn-and-regenerate path."""
    path = tmp_path / "p.json"
    monkeypatch.setenv("REPRO_PATTERN_ARTIFACT", str(path))
    heads = {(0, 0): patterns.HeadAssignment(
        patterns.template("frame_diag", window=1, sink=1), True, "spatial",
        40.0, 0.0, 1.0)}
    patterns.save_pattern_artifact(patterns.PatternArtifact(
        grid=(2, 4, 4), block_shape=(8, 8), tolerance_db=25.0, heads=heads),
        str(path))
    with patterns.use_artifact(patterns.install_artifact(str(path))):
        fault_lib.install_faults("artifact_corrupt:after=1")
        eng = _engine(_identity)
        eng.submit(_req(0, (2,)))
        eng.start()
        eng.result(0, timeout=30)
        eng.stop()
        with pytest.warns(RuntimeWarning, match="corrupt"):
            assert patterns.active_artifact() is None
    assert fault_lib.active_faults().counters() == {
        "fault_artifact_corrupt": 1}


ARCH = apply_overrides(get_smoke_config("vdit-paper"), ("model.num_layers=1",))
SHAPE = serve_lib.serving_shape(ARCH, "gen_512", smoke=True)


@pytest.mark.parametrize("policy", ["ripple", "static"])
def test_degraded_result_equals_a_dense_engine(policy):
    """``attn_nan`` at step 1 on the smoke vDiT: the batch trips (static
    twice, ripple once) and the result is the dense-policy engine's, bit
    for bit."""
    from repro_torch.launch.workloads import mixed_request_stream

    model = init_vdit(ARCH.model, seed=0, device="cpu", zero_init=False)
    factory, _ = serve_lib.make_sampler_factory(ARCH, (SHAPE,), model,
                                                device="cpu", sentinel=True)

    def run(pol, guard):
        reqs = [req for _, req in mixed_request_stream(ARCH, (SHAPE,), 2,
                                                       policy=pol)]
        eng = _engine(factory, max_batch=2, guardrail=guard)
        for r in reqs:
            eng.submit(r)
        eng.start()
        out = [eng.result(r.request_id, timeout=60) for r in reqs]
        eng.stop()
        return out, eng.metrics()

    dense, _ = run("dense", True)
    with patterns.use_artifact(None):
        fault_lib.install_faults("attn_nan:step=1")
        got, m = run(policy, True)
    assert m["degraded_count"] == (2 if policy == "static" else 1)
    assert m["dense_fallbacks"] == 1
    for g, d in zip(got, dense):
        assert g.degraded
        np.testing.assert_array_equal(g.latents, d.latents)


# ---------------------------------------------------------------------------
# The launcher's guardrail flags
# ---------------------------------------------------------------------------

def test_launcher_guardrails_change_no_number(tmp_path):
    """Guardrails on (the default) and off give the same latents bit for
    bit: the sentinels only read."""
    argv = ["--device", "cpu", "--smoke", "--requests", "2",
            "model.num_layers=1"]
    on = serve_lib.main(argv)
    off = serve_lib.main(argv + ["--no-guardrail"])
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.latents, b.latents)
        assert not a.degraded


def test_launcher_serves_through_an_injected_nan(tmp_path):
    import json

    path = tmp_path / "s.json"
    done = serve_lib.main(["--device", "cpu", "--smoke", "--requests", "3",
                           "--inject-faults", "attn_nan:step=1",
                           "--summary-json", str(path), "model.num_layers=1"])
    summary = json.loads(path.read_text())
    assert len(done) == 3 and all(r.degraded for r in done)
    assert all(np.isfinite(r.latents).all() for r in done)
    assert summary["counters"]["dense_fallbacks"] == 3  # one a bucket
    assert summary["counters"]["fault_attn_nan"] >= 3
    assert fault_lib.active_faults() is None  # the launcher cleared it


@pytest.mark.parametrize("spec", ["crash", "crash:after=1", "no_such_fault"])
def test_launcher_refuses_crash_and_unknown_faults(spec):
    with pytest.raises(SystemExit):
        serve_lib.main(["--device", "cpu", "--smoke", "--requests", "1",
                        "--inject-faults", spec])
    assert fault_lib.active_faults() is None


# ---------------------------------------------------------------------------
# The caches router replicas share
# ---------------------------------------------------------------------------

def _hammer(fn):
    """``fn`` on more threads than cores at once, with a short switch
    interval so that the threads interleave inside it."""
    errors = []
    n = (os.cpu_count() or 1) + 1
    start = threading.Barrier(n)

    def run():
        try:
            start.wait(timeout=60)
            fn()
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    ts = [threading.Thread(target=run) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors


def test_plan_cache_and_plan_store_under_threads(monkeypatch):
    """Threads resolving plans past the cache's cap, and building one
    constant plan at once: the cache stays within its cap, and the plan
    is built once and shared."""
    from repro_torch.config.base import RippleConfig

    monkeypatch.setattr(dispatch, "_PLAN_CACHE_CAP", 16)
    cfg = RippleConfig(enabled=True)

    def resolve():
        for n in range(64, 64 + 200):
            dispatch.resolve_plan((1, 2, 2 * n, 8), (1, 2, 2 * n, 8), cfg,
                                  on_cuda=False)
            time.sleep(0)

    _hammer(resolve)
    assert len(dispatch._PLAN_CACHE) <= 16
    patterns.clear_plans()
    builds = patterns.plan_builds
    spec = patterns.template("frame_diag", window=1, sink=1)
    got = []

    def build():
        got.append(patterns._constant_plan(
            "static", [spec] * 2, "threads", (8, 16, 16), 2048, None, 0,
            (128, 128), "cpu"))

    _hammer(build)
    assert patterns.plan_builds == builds + 1
    assert all(p is got[0] for p in got)
    patterns.clear_plans()

"""The port's SLO serving against the JAX package's, on the CPU with fake
samplers that sleep a few milliseconds: the engine's drain order on the
same queued heads, ``admission_decision``, ``choose_bucket`` and
``ServiceEstimator`` on seeded random cases, admission and EDF in the
engine, errored results kept for their TTL, and the router over
in-process replicas with failover."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.serving import engine as j_engine  # noqa: E402
from repro_torch.serving import engine as engine_lib  # noqa: E402
from repro_torch.serving.engine import DiffusionEngine, GenRequest  # noqa: E402


def _txt(val, tokens=1, dim=1):
    return np.full((tokens, dim), float(val), np.float32)


def _factory(shape, steps, policy=None, reuse_every=None, stream_every=None):
    return lambda noise, txt, seeds: noise


# Each case: (scheduler, [(enqueue offset s, latent shape, deadline offset
# s or None)], now offset s, batches to take first).  The engines are not
# started: both drain by ``_take_batch`` at a frozen clock.
DRAIN_CASES = {
    # A's head is older than starve_after_s: it wins over the deeper B.
    "starvation": ("edf", [(0.0, (1,), None), (1.0, (2,), None),
                           (1.1, (2,), None), (1.2, (2,), None)], 2.5, 0),
    # A tie in depth after one batch: the first bucket created wins, not
    # the oldest head.
    "tie": ("edf", [(0.0, (1,), None), (0.1, (2,), None), (0.2, (2,), None),
                    (0.3, (1,), None), (0.4, (1,), None)], 0.5, 1),
    # The earliest feasible deadline beats the deeper bucket.
    "deadline": ("edf", [(0.0, (1,), 60.0), (0.1, (1,), 60.0),
                         (0.2, (2,), 30.0)], 0.3, 0),
    # hottest ignores the deadline.
    "hottest": ("hottest", [(0.0, (1,), 60.0), (0.1, (1,), 60.0),
                            (0.2, (2,), 30.0)], 0.3, 0),
}


def _drain(engine, reqs, now, pre, monkeypatch):
    for t, req in reqs:
        monkeypatch.setattr(time, "time", lambda t=t: t)
        engine.submit(req)
    monkeypatch.setattr(time, "time", lambda: now)
    order = []
    for _ in range(pre + 1):
        key, batch = engine._take_batch()
        order.append((key[0], sorted(entry[1].request_id for entry in batch)))
    monkeypatch.undo()
    return order


@pytest.mark.parametrize("case", sorted(DRAIN_CASES))
def test_drain_order_equals_the_reference(case, monkeypatch):
    """On the same queued heads at the same ``now``, the port's engine
    takes the reference engine's batches (aging, then EDF, then the
    deepest bucket, ties to the first bucket created)."""
    scheduler, spec, now, pre = DRAIN_CASES[case]
    t0 = 1_000_000.0
    reqs = [(t0 + t, dict(request_id=i, txt=_txt(i), latent_shape=shape,
                          steps=2, **({} if dl is None
                                      else {"deadline_s": t0 + dl})))
            for i, (t, shape, dl) in enumerate(spec)]
    # The default scheduler is edf in both.
    kw = {} if scheduler == "edf" else {"scheduler": scheduler}
    port = DiffusionEngine(_factory, device="cpu", max_batch=1, max_wait_s=0.0,
                           **kw)
    ref = j_engine.DiffusionEngine(sampler_factory=_factory, max_batch=1,
                                   max_wait_s=0.0, **kw)
    got = _drain(port, [(t, GenRequest(**kw)) for t, kw in reqs], t0 + now,
                 pre, monkeypatch)
    want = _drain(ref, [(t, j_engine.GenRequest(**kw)) for t, kw in reqs],
                  t0 + now, pre, monkeypatch)
    assert got == want


# ---------------------------------------------------------------------------
# slo.py against the reference on seeded random cases
# ---------------------------------------------------------------------------

from repro.serving import slo as j_slo  # noqa: E402
from repro_torch.serving import slo  # noqa: E402
from repro_torch.serving.router import Router  # noqa: E402
from repro_torch.serving.slo import ServiceEstimator, ShedError  # noqa: E402

KEYS = [((4, 8, 8, 4), 3, "ripple", None, 1, (8, 64), None, None, 0),
        ((4, 4, 4, 4), 3, "static", 2, 1, (8, 64), 1, "0123abcd", 0),
        ((2,), 2, None, None, 1, (1, 1), None, None, 0)]


def _estimators(rng):
    """The same random observations in a port and a reference
    estimator."""
    ours, ref = ServiceEstimator(alpha=0.25), j_slo.ServiceEstimator(alpha=0.25)
    for _ in range(int(rng.integers(0, 6))):
        k = KEYS[int(rng.integers(len(KEYS)))]
        t = float(rng.uniform(0.01, 3.0))
        ours.observe(k, t)
        ref.observe(k, t)
    return ours, ref


@pytest.mark.parametrize("seed", range(4))
def test_slo_primitives_equal_the_reference(seed):
    """admission_decision, choose_bucket under both schedulers and the
    estimator's bounds, EWMA and watchdog hint: the same results on 50
    seeded random cases each."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        now = 1000.0 + float(rng.uniform(0, 10))
        deadline = (None if rng.random() < 0.2
                    else now + float(rng.uniform(-1.0, 8.0)))
        lb = None if rng.random() < 0.2 else float(rng.uniform(0.01, 3.0))
        args = (deadline, now, int(rng.integers(0, 9)),
                int(rng.integers(1, 5)), lb)
        assert slo.admission_decision(*args) == \
            j_slo.admission_decision(*args)
        ours, ref = _estimators(rng)
        for k in KEYS:
            assert ours.lower_bound(k) == ref.lower_bound(k)
            assert ours.expected(k) == ref.expected(k)
            assert ours.timeout_hint(k, 0.5) == ref.timeout_hint(k, 0.5)
        heads = {k: (now - float(rng.uniform(0, 3)),
                     None if rng.random() < 0.4
                     else now + float(rng.uniform(-1, 5)),
                     int(rng.integers(1, 6)))
                 for k in KEYS if rng.random() < 0.8}
        for scheduler in ("edf", "hottest"):
            kw = dict(scheduler=scheduler,
                      starve_after_s=float(rng.uniform(0.5, 4.0)))
            assert slo.choose_bucket(heads, now, estimator=ours, **kw) == \
                j_slo.choose_bucket(heads, now, estimator=ref, **kw)


def test_estimator_json_crosses_from_the_reference():
    """An estimator the reference wrote reads back in the port with the
    same bounds: the bucket keys are the same 9-tuples."""
    ours, ref = _estimators(np.random.default_rng(9))
    ref.observe(KEYS[1], 0.5)
    back = ServiceEstimator.from_json(ref.to_json())
    assert back.alpha == ref.alpha
    for k in KEYS:
        assert back.lower_bound(k) == ref.lower_bound(k)
        assert back.expected(k) == ref.expected(k)
    assert ServiceEstimator.from_json(back.to_json()).lower_bound(KEYS[1]) \
        == ref.lower_bound(KEYS[1])


# ---------------------------------------------------------------------------
# Admission and EDF in the engine (the reference's TestAdmissionInEngine
# and TestEDFBeatsHottest), errored results kept for their TTL
# ---------------------------------------------------------------------------

def _engine(factory=_factory, **kw):
    kw.setdefault("max_batch", 1)
    kw.setdefault("max_wait_s", 0.01)
    return DiffusionEngine(factory, device="cpu", **kw)


def _req(rid, shape=(2,), **kw):
    return GenRequest(request_id=rid, txt=_txt(rid), latent_shape=shape,
                      steps=2, **kw)


def test_expired_deadline_shed_before_any_compute():
    calls = []

    def factory(shape, steps):
        def fn(noise, txt, seeds):
            calls.append(1)
            return noise
        return fn

    eng = _engine(factory)
    eng.start()
    with pytest.raises(ShedError):
        eng.submit(_req(0, deadline_s=time.time() - 1.0))
    time.sleep(0.05)
    eng.stop()
    assert calls == []
    assert eng.metrics()["shed_count"] == 1
    with pytest.raises(TimeoutError):
        eng.result(0, timeout=0.01)


def test_provably_infeasible_shed_via_lower_bound():
    eng = _engine()
    req = _req(0, deadline_s=time.time() + 0.5)
    eng.estimator.observe(eng._bucket_key(req), 10.0)
    eng.start()
    with pytest.raises(ShedError):
        eng.submit(req)
    eng.stop()


def test_feasible_request_admitted_and_served():
    eng = _engine()
    req = _req(0, deadline_s=time.time() + 30.0)
    eng.estimator.observe(eng._bucket_key(req), 0.001)
    eng.start()
    eng.submit(req)
    r = eng.result(0, timeout=30)
    eng.stop()
    assert r.deadline_met is True
    assert eng.metrics()["deadlines_met"] == 1


def test_admission_control_off_never_sheds():
    eng = _engine(admission_control=False)
    eng.start()
    eng.submit(_req(0, deadline_s=time.time() - 1.0))
    r = eng.result(0, timeout=30)
    eng.stop()
    assert r.deadline_met is False
    assert eng.metrics()["shed_count"] == 0


def test_scheduler_must_be_edf_or_hottest():
    with pytest.raises(ValueError, match="scheduler"):
        _engine(scheduler="fifo")


@pytest.mark.parametrize("bad", [dict(deadline_s=-1.0), dict(steps=0),
                                 dict(latent_shape=()),
                                 dict(latent_shape=(2, 0))],
                         ids=["deadline", "steps", "empty", "zero"])
def test_malformed_requests_are_refused_at_the_door(bad):
    kw = dict(request_id=0, txt=_txt(0), latent_shape=(2,), steps=2)
    kw.update(bad)
    with pytest.raises(ValueError):
        _engine().submit(GenRequest(**kw))


SERVICE_S = 0.05


def _overload(scheduler):
    """The reference's overload trace: a deep bucket with relaxed
    deadlines and one tight request in a shallow bucket, queued before
    the worker starts."""
    def factory(shape, steps):
        def fn(noise, txt, seeds):
            time.sleep(SERVICE_S)
            return noise
        return fn

    eng = _engine(factory, max_wait_s=0.0, scheduler=scheduler,
                  starve_after_s=60.0)
    now = time.time()
    for i in range(4):
        eng.submit(_req(i, (4, 4), deadline_s=now + 30.0))
    eng.submit(_req(99, (2, 2), deadline_s=now + 2.5 * SERVICE_S))
    eng.start()
    for rid in (0, 1, 2, 3, 99):
        eng.result(rid, timeout=60)
    m = eng.metrics()
    eng.stop()
    return m


def test_edf_meets_strictly_more_deadlines():
    hot, edf = _overload("hottest"), _overload("edf")
    assert hot["deadlines_missed"] >= 1
    assert edf["deadlines_missed"] == 0
    assert edf["deadlines_met"] > hot["deadlines_met"]


def _failing(msg):
    def factory(shape, steps):
        def fn(noise, txt, seeds):
            raise ValueError(msg)
        return fn
    return factory


def test_retry_after_error_sees_original_error_not_timeout():
    eng = _engine(_failing("boom-original"), max_retries=0)
    eng.start()
    eng.submit(_req(0))
    for _ in range(3):
        with pytest.raises(RuntimeError, match="boom-original"):
            eng.result(0, timeout=30)
    eng.stop()


def test_errored_result_evicted_after_ttl():
    eng = _engine(_failing("boom"), max_retries=0, error_ttl_s=0.1)
    eng.start()
    eng.submit(_req(0))
    with pytest.raises(RuntimeError, match="boom"):
        eng.result(0, timeout=30)
    eng.stop()
    time.sleep(0.15)
    with pytest.raises(TimeoutError):
        eng.result(0, timeout=0.05)


def test_error_tombstone_lives_through_its_expiry_instant(monkeypatch):
    eng = _engine(_failing("boom-ttl"), max_retries=0)
    eng.start()
    eng.submit(_req(0))
    with pytest.raises(RuntimeError, match="boom-ttl"):
        eng.result(0, timeout=30)
    eng.stop()
    frozen = eng._error_expiry[0]
    monkeypatch.setattr(engine_lib.time, "time", lambda: frozen)
    with pytest.raises(RuntimeError, match="boom-ttl"):
        eng.result(0, timeout=30)
    monkeypatch.undo()
    eng._error_expiry[0] = time.time() - 0.001
    with pytest.raises(TimeoutError):
        eng.result(0, timeout=0.01)


# ---------------------------------------------------------------------------
# The router (the reference's TestRouter, TestRouterHealthProbes and
# TestGuardrailFailover)
# ---------------------------------------------------------------------------

def _replica(service_s=0.0, max_batch=1, **kw):
    def factory(shape, steps):
        def fn(noise, txt, seeds):
            if service_s:
                time.sleep(service_s)
            return noise
        return fn

    return _engine(factory, max_batch=max_batch, max_wait_s=0.0, **kw)


def test_router_needs_a_replica():
    with pytest.raises(ValueError):
        Router([])


def test_router_balances_across_replicas_by_depth():
    router = Router([_replica(service_s=0.05) for _ in range(2)])
    router.start()
    placed = [router.submit(_req(i)) for i in range(4)]
    for i in range(4):
        router.result(i, timeout=30)
    router.stop()
    assert set(placed) == {0, 1}


def test_router_sheds_fleet_wide_only_when_all_refuse():
    router = Router([_replica() for _ in range(2)])
    router.start()
    with pytest.raises(ShedError):
        router.submit(_req(0, deadline_s=time.time() - 1.0))
    router.stop()
    m = router.metrics()
    assert m["router_shed_count"] == 1
    assert m["replica0_shed_count"] + m["replica1_shed_count"] == 2


def test_router_failover_requeues_unserved_requests():
    router = Router([_replica(service_s=0.05) for _ in range(2)])
    router.start()
    for i in range(8):
        router.submit(_req(i, seed=i))
    time.sleep(0.02)
    router.fail_replica(0)
    results = {i: router.result(i, timeout=60) for i in range(8)}
    assert router.healthy_replicas() == [1]
    m = router.metrics()
    router.stop()
    assert all(r.latents.shape == (2,) for r in results.values())
    assert m["router_requeued"] >= 1


def test_router_result_follows_failover_when_waiting():
    import threading

    router = Router([_replica(service_s=0.1) for _ in range(2)])
    router.start()
    placed = [router.submit(_req(i)) for i in range(4)]
    got = {}

    def waiter():
        got["res"] = router.result(3, timeout=60)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.03)
    router.fail_replica(placed[-1])
    t.join(timeout=60)
    for i in range(3):
        router.result(i, timeout=60)
    router.stop()
    assert not t.is_alive()
    assert got["res"].latents.shape == (2,)


def _streaming_factory(blocker_s=0.0):
    def factory(shape, steps, policy=None, reuse_every=None,
                stream_every=None):
        if stream_every is None:
            def fn(noise, txt, seeds):
                time.sleep(blocker_s)
                return noise
            return fn

        def gen_fn(noise, txt, seeds):
            for k in range(1, 4):
                time.sleep(0.01)
                yield noise + k, None
        return gen_fn
    return factory


def test_router_stream_passes_through():
    router = Router([_engine(_streaming_factory(), max_wait_s=0.0)])
    router.start()
    router.submit(_req(0, stream_every=1))
    chunks = list(router.stream(0, timeout=30))
    r = router.result(0, timeout=30)
    router.stop()
    assert len(chunks) == 3
    np.testing.assert_array_equal(chunks[-1], r.latents)


def test_router_stream_follows_failover():
    import threading

    router = Router([_engine(_streaming_factory(0.15), max_wait_s=0.0)
                     for _ in range(2)])
    router.start()
    router.submit(_req(0))
    router.submit(_req(1))
    victim = router.submit(_req(2, stream_every=1))
    got = []

    def consume():
        got.extend(router.stream(2, timeout=30))

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.03)
    router.fail_replica(victim)
    t.join(timeout=60)
    res = router.result(2, timeout=60)
    for rid in (0, 1):
        router.result(rid, timeout=60)
    router.stop()
    assert not t.is_alive()
    assert len(got) == 3
    np.testing.assert_array_equal(got[-1], res.latents)


def test_router_forget_releases_ledger_after_timeout():
    router = Router([_replica(service_s=0.3)])
    router.start()
    idx = router.submit(_req(0))
    with pytest.raises(TimeoutError):
        router.result(0, timeout=0.01)
    assert router.depths()[idx] >= 1
    router.forget(0)
    router.forget(0)
    assert router.depths()[idx] == 0
    with pytest.raises(KeyError):
        router.result(0, timeout=1)
    router.stop()


def test_router_stop_claims_each_replica_exactly_once():
    router = Router([_replica() for _ in range(2)])
    router.start()
    stops = []
    for i, eng in enumerate(router._replicas):
        orig = eng.stop

        def spy(drain=True, _i=i, _orig=orig):
            stops.append((_i, drain))
            _orig(drain=drain)

        eng.stop = spy
    router.stop()
    router.fail_replica(0)
    router.stop()
    assert stops == [(0, True), (1, True)]


def test_router_restart_restores_replica_health():
    router = Router([_replica()])
    router.start()
    router.stop()
    assert router.healthy_replicas() == []
    router.start()
    assert router.healthy_replicas() == [0]
    router.submit(_req(0))
    assert router.result(0, timeout=30).latents.shape == (2,)
    router.stop()


def test_probe_health_readmits_restarted_replica():
    router = Router([_replica() for _ in range(2)])
    router.start()
    router.fail_replica(0)
    assert router.healthy_replicas() == [1]
    assert router.probe_health() == []
    router._replicas[0].start()
    assert router.probe_health() == [0]
    assert router.healthy_replicas() == [0, 1]
    assert router.metrics()["router_readmitted"] == 1
    placed = [router.submit(_req(i)) for i in range(4)]
    for i in range(4):
        router.result(i, timeout=30)
    router.stop()
    assert 0 in placed


def test_probe_thread_readmits_on_interval():
    router = Router([_replica() for _ in range(2)], probe_interval_s=0.02)
    router.start()
    router.fail_replica(0)
    router._replicas[0].start()
    deadline = time.time() + 5.0
    while router.healthy_replicas() != [0, 1] and time.time() < deadline:
        time.sleep(0.01)
    healthy = router.healthy_replicas()
    router.stop()
    assert healthy == [0, 1]


def test_degraded_state_survives_replica_failover():
    """Replicas share one ladder: the survivor serves a family degraded
    on the failed replica at its degraded rung."""
    from repro_torch.core.guardrail import DegradationLadder

    ladder = DegradationLadder()

    def factory(shape, steps, policy=None):
        def fn(noise, txt, seeds):
            if policy != "dense":
                return torch.full_like(noise, float("nan"))
            return torch.zeros_like(noise)
        return fn

    router = Router([_engine(factory, max_wait_s=0.0, guardrail=ladder)
                     for _ in range(2)])
    router.start()
    victim = router.submit(_req(0))
    r0 = router.result(0, timeout=30)
    assert r0.degraded and np.all(np.isfinite(r0.latents))
    assert ladder.metrics()["degraded_count"] == 1
    router.fail_replica(victim)
    router.submit(_req(1))
    r1 = router.result(1, timeout=30)
    router.stop()
    assert r1.degraded and np.all(np.isfinite(r1.latents))
    assert ladder.metrics()["degraded_count"] == 1  # no second trip


# ---------------------------------------------------------------------------
# Failover on the smoke vDiT, and the launcher's control-plane flags
# ---------------------------------------------------------------------------

from repro_torch.config.base import apply_overrides  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch.workloads import mixed_request_stream  # noqa: E402
from repro_torch.models.params import init_vdit  # noqa: E402

ARCH = apply_overrides(get_smoke_config("vdit-paper"), ("model.num_layers=1",))
SHAPE = serve_lib.serving_shape(ARCH, "gen_512", smoke=True)


def test_failed_over_results_equal_a_fault_free_run():
    """Two replicas of the smoke vDiT behind a router, one failed while
    its requests wait: every request completes on the survivor, and each
    result equals a fault-free single engine's bit for bit (batches of
    one, so the members are the same)."""
    model = init_vdit(ARCH.model, seed=0, device="cpu", zero_init=False)
    factory, _ = serve_lib.make_sampler_factory(ARCH, (SHAPE,), model,
                                                device="cpu", sentinel=True)

    def slow(shape, steps, policy=None, reuse_every=None, stream_every=None):
        fn = factory(shape, steps, policy, reuse_every, stream_every)

        def run(noise, txt, seeds):
            time.sleep(0.02)
            return fn(noise, txt, seeds)
        return run

    reqs = [req for _, req in mixed_request_stream(ARCH, (SHAPE,), 6,
                                                   policy="ripple")]
    ref = _engine(factory, guardrail=True)
    for r in reqs:
        ref.submit(r)
    ref.start()
    want = {r.request_id: ref.result(r.request_id, timeout=60) for r in reqs}
    ref.stop()
    router = Router([_engine(slow, guardrail=True) for _ in range(2)])
    router.start()
    placed = [router.submit(r) for r in reqs]
    router.fail_replica(placed[0])
    got = {r.request_id: router.result(r.request_id, timeout=60)
           for r in reqs}
    m = router.metrics()
    router.stop()
    assert m["router_requeued"] >= 1
    for rid, r in got.items():
        np.testing.assert_array_equal(r.latents, want[rid].latents)


def _summary(tmp_path, argv):
    import json

    path = tmp_path / "s.json"
    done = serve_lib.main(["--device", "cpu", "--smoke", "model.num_layers=1",
                           "--summary-json", str(path)] + argv)
    return done, json.loads(path.read_text())


def _reference_summary_keys():
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    tree = ast.parse((root / "src" / "repro" / "launch" / "serve.py")
                     .read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "summary"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no summary dict in the reference launcher")


def test_launcher_sheds_every_request_past_its_deadline(tmp_path):
    done, summary = _summary(tmp_path, ["--requests", "3",
                                        "--deadline-ms", "0.001"])
    assert done == [] and summary["shed"] == 3
    assert summary["submitted"] == summary["completed"] == []
    assert summary["counters"]["shed_count"] == 3
    assert set(summary) == _reference_summary_keys()


def test_launcher_serves_through_two_replicas(tmp_path):
    """``--replicas 2`` with deadlines and streaming: every request
    completes (its chunks through the router), the counters are the
    router's and each replica's."""
    done, summary = _summary(tmp_path, [
        "--requests", "4", "--replicas", "2", "--deadline-ms", "60000",
        "--stream-every", "2", "--scheduler", "hottest"])
    assert sorted(r.request_id for r in done) == [0, 1, 2, 3]
    assert summary["completed"] == summary["submitted"] == [0, 1, 2, 3]
    assert not summary["errors"] and summary["shed"] == 0
    c = summary["counters"]
    assert c["replica0_batches_served"] + c["replica1_batches_served"] >= 3
    assert c["replica0_deadlines_met"] + c["replica1_deadlines_met"] == 4
    assert c["router_requeued"] == 0
    assert set(summary) == _reference_summary_keys()

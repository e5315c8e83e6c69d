"""Mid-flight resume in the port (DESIGN.md §18), on the CPU: the
streamed sampler resumed from a chunk checkpoint against its
uninterrupted run (bit for bit, vdit with and without the decision
cache, the image DiT), a checkpoint the JAX engine wrote resumed by the
port against the JAX package's own resume, the engine's journal and
checkpoint lifecycle, the router's checkpointed failover, and the
launcher's crash drill and SIGTERM drain in subprocesses."""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import apply_overrides as j_apply_overrides  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.launch import workloads as j_workloads  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.models.vdit import vdit_defs  # noqa: E402
from repro.serving import engine as j_engine  # noqa: E402
from repro.serving import journal as j_journal  # noqa: E402
from repro_torch.config.base import apply_overrides  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models.params import (init_dit, init_vdit,  # noqa: E402
                                       params_from_numpy)
from repro_torch.serving import journal  # noqa: E402
from repro_torch.serving.engine import (DiffusionEngine, GenRequest,  # noqa: E402
                                        request_noise)
from repro_torch.serving.router import Router  # noqa: E402
from repro_torch.serving.slo import ShedError  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every step snaps (θ ramps over steps 0-1) so a resumed hit step replays
# real snaps.
SCHED = ("ripple.i_min=0", "ripple.i_max=1", "model.num_layers=1")
VDIT = apply_overrides(get_smoke_config("vdit-paper"), SCHED)
CACHED = apply_overrides(VDIT, ("ripple.reuse_every=2",))
DIT = apply_overrides(get_smoke_config("dit-xl2"), ("model.num_layers=1",))


def _txt(seed, shape=(8, 64)):
    return (0.05 * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# The streamed sampler resumed from its own checkpoints
# ---------------------------------------------------------------------------

def _sampler(arch, steps, chunk):
    shape = serve_lib.serving_shape(
        arch, "gen_1024" if arch.family == "dit" else "gen_512", smoke=True,
        steps=steps)
    init = init_dit if arch.family == "dit" else init_vdit
    model = init(arch.model, seed=1, device="cpu", zero_init=False)
    return serve_lib.build_sampler(arch, shape, model, stream_every=chunk,
                                   compute_dtype=torch.float32)


@pytest.mark.parametrize("arch,chunk,step", [
    (VDIT, 2, 2), (VDIT, 1, 3), (CACHED, 1, 1), (CACHED, 1, 3),
    (CACHED, 2, 4), (DIT, 1, 3)],
    ids=["vdit@2", "vdit@3", "cache@1-hit", "cache@3-hit",
         "cache@4-refresh", "dit@3"])
def test_streamed_sampler_resumes_bit_for_bit(arch, chunk, step):
    """Resumed from the ``__ckpt__`` of the chunk that ends at ``step``
    (its latents, step and decision state), the sampler yields exactly
    the uninterrupted run's remaining chunks, bit for bit, with their
    checkpoints' steps and the same cache counters."""
    fn, lat = _sampler(arch, 6, chunk)
    noise = torch.stack([request_noise(s, lat, "cpu") for s in (1, 2)])
    txt = torch.from_numpy(np.stack([_txt(1), _txt(2)]))
    seeds = [1, 2]
    whole = list(fn(noise, txt, seeds))
    cks = [aux.pop("__ckpt__") for _, aux in whole]
    at = step // chunk - 1
    ck = cks[at]
    assert ck["step"] == step
    assert (ck["dstate"] is not None) == (arch is CACHED)
    resumed = list(fn(whole[at][0], txt, seeds,
                      resume={"step": ck["step"], "dstate": ck["dstate"]}))
    assert len(resumed) == len(whole) - at - 1
    for (got, aux), (want, want_aux), want_ck in zip(
            resumed, whole[at + 1:], cks[at + 1:]):
        assert torch.equal(got, want)
        assert aux.pop("__ckpt__")["step"] == want_ck["step"]
        assert {k: int(v) for k, v in aux.items()} == \
            {k: int(v) for k, v in want_aux.items()}
    if arch is CACHED:
        assert int(whole[-1][1]["cache_hits"]) > 0


def test_cached_sampler_without_a_state_replays_from_step_zero():
    """A cache-threading sampler resumed without its decision state
    replays the whole run from the requests' initial noise (their
    seeds), not from the checkpoint's latents: the same result."""
    fn, lat = _sampler(CACHED, 4, 1)
    noise = torch.stack([request_noise(s, lat, "cpu") for s in (3, 4)])
    txt = torch.from_numpy(np.stack([_txt(3), _txt(4)]))
    whole = list(fn(noise, txt, [3, 4]))
    replay = list(fn(whole[1][0], txt, [3, 4],
                     resume={"step": 2, "dstate": None}))
    assert len(replay) == len(whole)
    assert torch.equal(replay[-1][0], whole[-1][0])
    with pytest.raises(ValueError, match="seed"):
        list(fn(whole[1][0], txt, None, resume={"step": 2, "dstate": None}))


# ---------------------------------------------------------------------------
# A checkpoint the JAX engine wrote, resumed by the port
# ---------------------------------------------------------------------------

def test_port_resumes_a_jax_checkpoint_like_the_jax_package(tmp_path,
                                                             monkeypatch):
    """The JAX engine serves a streamed vdit request under the decision
    cache and its store writes a checkpoint at step 1 (a cache hit
    step); the directory is copied right after.  From that copy the JAX
    engine resumes the request and the port resumes it (request from the
    journal, checkpoint with its layer-stacked decision state, params
    through ``params_from_numpy``), both in float32: the results agree
    within relative L2 1e-3."""
    sched = SCHED + ("ripple.reuse_every=2",)
    j_arch = j_apply_overrides(j_smoke_config("vdit-paper"), sched)
    arch = apply_overrides(get_smoke_config("vdit-paper"), sched)
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
    j_shape = serve_lib.serving_shape(j_arch, "gen_512", smoke=True)
    shape = serve_lib.serving_shape(arch, "gen_512", smoke=True)
    lat = serve_lib.latent_shape_for(arch, shape)
    live, snap = str(tmp_path / "live"), str(tmp_path / "snap")
    store = j_journal.CheckpointStore(live)
    put = store.put

    def put_then_copy(rid, **kw):
        put(rid, **kw)
        if not os.path.exists(snap):
            shutil.copytree(live, snap)

    store.put = put_then_copy
    factory, _ = j_serve.make_sampler_factory(
        j_arch, (j_shape,), jax.tree_util.tree_map(jnp.asarray, tree))
    eng = j_engine.DiffusionEngine(sampler_factory=factory, max_batch=1,
                                   max_wait_s=0.0,
                                   journal=j_journal.Journal(live),
                                   checkpoint_store=store)
    eng.start()
    try:
        eng.submit(j_engine.GenRequest(request_id=0, txt=_txt(9), steps=3,
                                       seed=7, latent_shape=lat,
                                       stream_every=1))
        eng.result(0, timeout=300)
        rec = journal.recover(snap)
        assert not rec.clean and sorted(rec.pending) == [0]
        ck = journal.CheckpointStore(snap).get(0)
        j_ck = j_journal.CheckpointStore(snap).get(0)
        assert ck["step"] == j_ck["step"] == 1 and ck["dstate"] is not None
        j_req = dataclasses.replace(
            j_journal.request_from_dict(rec.pending[0]), request_id=1,
            resume={"step": 1, "x": j_ck["x"], "dstate": j_ck["dstate"]})
        eng.submit(j_req)
        want = eng.result(1, timeout=300).latents
    finally:
        eng.stop()
    req = journal.request_from_dict(rec.pending[0])
    req.resume = {"step": ck["step"], "x": ck["x"], "dstate": ck["dstate"]}
    p_factory, _ = serve_lib.make_sampler_factory(
        arch, (shape,), params_from_numpy(tree, arch.model, device="cpu"),
        device="cpu", compute_dtype=torch.float32)
    got = _serve(DiffusionEngine(p_factory, device="cpu"), [req])[0].latents
    want = np.asarray(want)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3


# ---------------------------------------------------------------------------
# The engine's journal, checkpoints and resume
# ---------------------------------------------------------------------------

STEPS = 4


def _counting_factory(delay_s=0.0):
    """A streaming sampler honouring ``resume=``: x gains 1 a step from
    its start step, so any trajectory is known exactly."""
    def factory(shape, steps, policy=None, reuse_every=None,
                stream_every=None):
        def fn(noise, txt, seeds, resume=None):
            start = 0 if resume is None else int(resume["step"])
            cur = noise
            for s in range(start, steps):
                if delay_s:
                    time.sleep(delay_s)
                cur = cur + 1.0
                yield cur, {"__ckpt__": {"step": s + 1, "dstate": None}}
        return fn
    return factory


def _req(rid, **kw):
    kw.setdefault("txt", np.full((2, 3), float(rid), np.float32))
    kw.setdefault("latent_shape", (4,))
    return GenRequest(request_id=rid, **kw)


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        return [engine.result(r.request_id, timeout=300) for r in reqs]
    finally:
        engine.stop()


def _journaled(tmp_path, **kw):
    j = journal.Journal(str(tmp_path))
    store = journal.CheckpointStore(str(tmp_path))
    eng = DiffusionEngine(_counting_factory(), device="cpu", max_batch=2,
                          max_wait_s=0.05, journal=j, checkpoint_store=store,
                          **kw)
    return eng, j, store


def test_engine_journals_the_lifecycle_and_discards_the_checkpoint(tmp_path):
    """submitted before the chunks, a chunk record a step, finished last;
    a checkpoint at each boundary but the final one, gone at finish;
    resume then serves only the remaining steps, bit-equal, counted."""
    eng, j, store = _journaled(tmp_path)
    puts = []
    put = store.put
    store.put = lambda rid, **kw: (puts.append(kw["step"]), put(rid, **kw))
    eng.submit(_req(0, steps=STEPS, stream_every=1, seed=3))
    eng.start()
    try:
        chunks = list(eng.stream(0, timeout=30))
        full = eng.result(0, timeout=30)
    finally:
        eng.stop()
    records, _ = journal.scan_records(os.path.join(str(tmp_path),
                                                   journal.JOURNAL_FILE))
    assert [(r["ev"], r.get("chunk"), r.get("step")) for r in records] == (
        [("submitted", None, None)]
        + [("chunk", c, c + 1) for c in range(STEPS)]
        + [("finished", None, None)])
    assert puts == list(range(1, STEPS)) and store.count() == 0
    m = eng.metrics()
    assert m["checkpoint_writes"] == STEPS - 1 and m["resumed_count"] == 0
    assert m["journal_appends"] == STEPS + 2
    x2 = chunks[1]  # the latents at step 2
    eng2 = DiffusionEngine(_counting_factory(), device="cpu",
                           journal=j, checkpoint_store=store)
    res = _serve(eng2, [_req(1, steps=STEPS, stream_every=1, seed=3,
                             resume={"step": 2, "x": x2, "dstate": None})])
    np.testing.assert_array_equal(res[0].latents, full.latents)
    m2 = eng2.metrics()
    assert (m2["resumed_count"], m2["last_resume_step"]) == (1, 2)
    assert eng2._bucket_key(_req(1, steps=STEPS, stream_every=1, resume={
        "step": 2, "x": x2}))[8] == 2
    j.close()
    rec = journal.recover(str(tmp_path))
    assert rec.clean and not rec.pending and rec.finished == {0: None,
                                                              1: None}


def test_engine_counts_recovered_and_journals_a_shed(tmp_path):
    eng, j, _ = _journaled(tmp_path)
    req = _req(0, steps=STEPS, stream_every=1)
    req.recovered = True
    eng.submit(req)
    with pytest.raises(ShedError):
        eng.submit(_req(1, steps=STEPS, deadline_s=time.time() - 1.0))
    _serve(eng, [])
    assert eng.result(0, timeout=30).error is None
    assert eng.metrics()["recovered_count"] == 1
    j.close()
    rec = journal.recover(str(tmp_path))
    assert list(rec.shed) == [1] and "shed" in rec.shed[1]
    assert rec.finished == {0: None}


@pytest.mark.parametrize("resume", [
    {"step": 1}, {"step": -1, "x": np.zeros(4)},
    {"step": STEPS, "x": np.zeros(4)}, {"step": 1, "x": np.zeros(4)},
    {"step": 2.0, "x": np.zeros(4)}],
    ids=["no x", "negative", "past the end", "off a boundary", "float"])
def test_engine_refuses_an_invalid_resume_payload(resume):
    eng = DiffusionEngine(_counting_factory(), device="cpu")
    with pytest.raises(ValueError, match="resume"):
        eng.submit(_req(9, steps=STEPS, stream_every=2, resume=resume))


def test_a_sampler_without_resume_replays_from_step_zero(caplog):
    """A factory whose sampler takes no ``resume=`` still serves a
    checkpointed request, by replay from step 0 (fresh noise, all
    steps), with a warning."""
    seen = []

    def factory(shape, steps, policy=None, reuse_every=None,
                stream_every=None):
        def fn(noise, txt, seeds):
            seen.append(noise.clone())
            return noise + float(steps)
        return fn

    x = np.full((4,), 5.0, np.float32)
    res = _serve(DiffusionEngine(factory, device="cpu"), [_req(
        0, steps=STEPS, stream_every=2, seed=1,
        resume={"step": 2, "x": x, "dstate": None})])[0]
    want = request_noise(1, (4,), "cpu")
    assert torch.equal(seen[0][0], want)
    np.testing.assert_array_equal(res.latents, (want + STEPS).numpy())
    assert "replaying 1 checkpointed request(s) from step 0" in caplog.text


# ---------------------------------------------------------------------------
# The router's checkpointed failover
# ---------------------------------------------------------------------------

def test_with_checkpoint_snapshot_rules(tmp_path):
    store = journal.CheckpointStore(str(tmp_path))
    router = Router([DiffusionEngine(_counting_factory(), device="cpu")],
                    checkpoint_store=store)
    x = torch.zeros(4)
    req = _req(1, steps=8, stream_every=2)
    assert router._with_checkpoint(req) is req  # no checkpoint yet
    store.put(1, step=4, x=x, seed=0)
    out = router._with_checkpoint(req)
    assert out is not req and out.resume["step"] == 4
    assert torch.equal(out.resume["x"], x) and out.resume["dstate"] is None
    store.put(2, step=3, x=x, seed=0)   # not a chunk boundary
    assert router._with_checkpoint(
        _req(2, steps=8, stream_every=2)).resume is None
    store.put(3, step=8, x=x, seed=0)   # the final step: nothing left
    assert router._with_checkpoint(
        _req(3, steps=8, stream_every=2)).resume is None
    store.put(4, step=2, x=x, seed=0)   # older than its current resume
    stale = _req(4, steps=8, stream_every=2,
                 resume={"step": 4, "x": x, "dstate": None})
    assert router._with_checkpoint(stale).resume["step"] == 4
    store.put(5, step=2, x=x, seed=0)   # no streaming cadence
    assert router._with_checkpoint(_req(5, steps=8)).resume is None


def test_failover_resumes_past_the_checkpoint_with_one_stream(tmp_path):
    """The replica serving a checkpointed request hangs past its watchdog
    after two chunks; the survivor resumes from the checkpoint (not from
    step 0), the stream stays one contiguous chunk sequence, and the
    result equals an uninterrupted twin's."""
    store = journal.CheckpointStore(str(tmp_path))
    slow = DiffusionEngine(_counting_factory(0.2), device="cpu", max_batch=1,
                           max_wait_s=0.01, checkpoint_store=store,
                           batch_timeout_s=0.5)
    fast = DiffusionEngine(_counting_factory(), device="cpu", max_batch=1,
                           max_wait_s=0.01, checkpoint_store=store)
    router = Router([slow, fast], checkpoint_store=store)
    router.start()
    try:
        router.submit(_req(0, steps=STEPS, stream_every=1, seed=1))
        chunks = list(router.stream(0, timeout=30))
        res = router.result(0, timeout=30)
        router.submit(_req(1, steps=STEPS, stream_every=1, seed=1))
        twin = router.result(1, timeout=30)
        m = router.metrics()
    finally:
        router.stop()
    assert m["router_requeued"] >= 1 and m["router_resumed"] >= 1
    assert m["router_resumed_from_step"] >= 1
    np.testing.assert_array_equal(res.latents, twin.latents)
    assert len(chunks) == STEPS
    for a, b in zip(chunks, chunks[1:]):
        np.testing.assert_allclose(b - a, np.ones(4, np.float32), rtol=1e-6)
    np.testing.assert_array_equal(chunks[-1], res.latents)


# ---------------------------------------------------------------------------
# The launcher: crash drill and graceful drain, in subprocesses
# ---------------------------------------------------------------------------

LAUNCH = ["--device", "cpu", "--smoke", "--requests", "4", "--max-batch",
          "1", "--stream-every", "1", "--steps", "24"]


def _launch(args, **kw):
    # The threads of this process, so that its CPU matmuls round alike.
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    env.pop("REPRO_FAULTS", None)
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve",
                             *args], env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, **kw)


def test_crash_then_resume_completes_every_pending_request(tmp_path):
    """``crash:after=1`` SIGKILLs the launcher mid-generation (a
    checkpoint of work in flight on disk, no clean marker); ``--resume``
    then completes every pending request, one from its checkpoint, with
    latents equal to an uninterrupted run's, and leaves a clean
    journal."""
    d = str(tmp_path / "j")
    proc = _launch(LAUNCH + ["--journal", d, "--inject-faults",
                             "crash:after=1"])
    _, err = proc.communicate(timeout=240)
    assert proc.returncode == -signal.SIGKILL, err.decode()[-2000:]
    rec = journal.recover(d)
    store = journal.CheckpointStore(d)
    steps = {rid: r["steps"] for rid, r in rec.pending.items()}
    mid = [rid for rid in store.rids() if rid in steps
           and 0 < store.get(rid)["step"] < steps[rid]]
    assert not rec.clean and rec.pending and mid
    path = str(tmp_path / "summary.json")
    done = serve_lib.main(LAUNCH + ["--requests", "0", "--journal", d,
                                    "--resume", "--summary-json", path])
    summary = json.loads(open(path, encoding="utf-8").read())
    assert summary["recovered"] == len(rec.pending)
    assert sorted(summary["completed"]) == sorted(rec.pending)
    assert not summary["errors"] and summary["resumed_from_step"] > 0
    c = summary["counters"]
    assert c["recovered_count"] == len(rec.pending)
    assert c["resumed_count"] >= 1 and c["checkpoint_writes"] > 0
    assert os.path.exists(os.path.join(d, journal.CLEAN_MARKER))
    after = journal.recover(d)
    assert after.clean and not after.pending
    assert os.path.exists(os.path.join(d, "estimator.json"))
    whole = {r.request_id: r.latents for r in serve_lib.main(LAUNCH)}
    for r in done:
        np.testing.assert_array_equal(r.latents, whole[r.request_id])
    # New traffic after the restart takes ids above the journaled ones.
    again = serve_lib.main(LAUNCH[:3] + ["--requests", "1", "--journal", d])
    assert [r.request_id for r in again] == [4]


def test_sigterm_drains_gracefully_and_keeps_the_queue(tmp_path):
    """SIGTERM while the first batch runs: exit 143, the clean-shutdown
    marker written, the queued requests still pending in the journal,
    and the summary says so."""
    d = str(tmp_path / "j")
    path = str(tmp_path / "summary.json")
    proc = _launch(LAUNCH + ["--journal", d, "--inject-faults",
                             "hang:seconds=4", "--summary-json", path])
    log = os.path.join(d, journal.JOURNAL_FILE)
    deadline = time.time() + 120
    while time.time() < deadline and proc.poll() is None:
        records, _ = journal.scan_records(log)
        if sum(r["ev"] == "submitted" for r in records) == 4:
            break
        time.sleep(0.05)
    time.sleep(0.5)  # the worker is in the injected hang now
    proc.send_signal(signal.SIGTERM)
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 143, err.decode()[-2000:]
    assert os.path.exists(os.path.join(d, journal.CLEAN_MARKER))
    rec = journal.recover(d)
    assert rec.clean and len(rec.pending) >= 1
    assert len(rec.pending) + len(rec.finished) == 4
    summary = json.loads(open(path, encoding="utf-8").read())
    assert summary["sigterm"] is True
    assert set(summary["completed"]) <= set(rec.finished)

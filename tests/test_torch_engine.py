"""The port's serving engine and launcher against the JAX package's, on
the CPU at smoke size: bucket keys and pattern tokens element by
element, mixed traffic, DDIM in chunks against one run, the streaming
engine, the streamed sampler against the JAX launcher's, per-request
policies in one engine, an artifact swap between two steps of a served
batch, and the launcher's flags."""

import ast
import dataclasses
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import apply_overrides as j_apply_overrides  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core import patterns as j_patterns  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.launch import workloads as j_workloads  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.models.vdit import vdit_defs  # noqa: E402
from repro.serving import engine as j_engine  # noqa: E402
from repro_torch.config.base import apply_overrides  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import patterns  # noqa: E402
from repro_torch.diffusion.sampler import ddim_sample  # noqa: E402
from repro_torch.diffusion.schedule import DDPMSchedule  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import workloads  # noqa: E402
from repro_torch.models.params import init_vdit, params_from_numpy  # noqa: E402
from repro_torch.serving import engine as engine_lib  # noqa: E402
from repro_torch.serving.engine import (DiffusionEngine, GenRequest,  # noqa: E402
                                        request_noise)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = apply_overrides(get_smoke_config("vdit-paper"), ("model.num_layers=1",))
SHAPE = serve_lib.serving_shape(ARCH, "gen_512", smoke=True)  # 64², 3 steps
LAT = serve_lib.latent_shape_for(ARCH, SHAPE)
SMOKE_GRID = (4, 4, 4)


@pytest.fixture
def clean_state(tmp_path, monkeypatch):
    """No active artifact in either package before and after, and none
    read from a user cache."""
    monkeypatch.setenv("REPRO_PATTERN_ARTIFACT", str(tmp_path / "none.json"))
    patterns.clear_plans()
    with patterns.use_artifact(None), j_patterns.use_artifact(None):
        yield
    patterns.clear_plans()


@pytest.fixture(scope="module")
def model():
    return init_vdit(ARCH.model, seed=0, device="cpu", zero_init=False)


def _artifact(mod, second: bool = False):
    """A smoke-grid artifact built from ``mod`` (either package's patterns
    module): head 0 static on a frame-diagonal window; head 1 dynamic, or
    with ``second`` static on a spatial window."""
    heads = {(0, 0): mod.HeadAssignment(
        mod.template("frame_diag", window=1, sink=1), True, "spatial", 40.0,
        0.0, 1.0)}
    heads[(0, 1)] = (
        mod.HeadAssignment(mod.template("spatial_local", radius=1), True,
                           "spatial", 40.0, 0.0, 1.0) if second else
        mod.HeadAssignment(mod.template("dense"), False, "dynamic", 0.0,
                           0.0, 0.5))
    return mod.PatternArtifact(grid=SMOKE_GRID, block_shape=(32, 32),
                               tolerance_db=25.0, heads=heads)


def _install_in_both(tmp_path, second=False):
    path = str(tmp_path / "p.json")
    patterns.save_pattern_artifact(_artifact(patterns, second), path)
    art = patterns.install_artifact(path)
    assert j_patterns.install_artifact(path).version == art.version
    return art


def _txt(seed, shape=(8, 64)):
    return (0.05 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _serve(engine, reqs):
    """Submit every request before the worker starts (so batches are
    deterministic), then read the results in order."""
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        return [engine.result(r.request_id, timeout=300) for r in reqs]
    finally:
        engine.stop()


# ---------------------------------------------------------------------------
# Bucket keys and pattern tokens against the reference engine
# ---------------------------------------------------------------------------

def _factory5(shape, steps, policy=None, reuse_every=None,
              stream_every=None):
    return lambda noise, txt, seeds: noise


KEY_CASES = {
    "plain": ({}, {}),
    "policy": ({"policy": "svg"}, {}),
    "static": ({"policy": "static"}, {}),
    "rainfusion": ({"policy": "rainfusion"}, {}),
    "cadence": ({"reuse_every": 4}, {}),
    "stream": ({"stream_every": 2}, {}),
    "text": ({"txt": _txt(1, (5, 32))}, {}),
    "defaults": ({}, {"default_policy": "static", "default_reuse_every": 2}),
    "all": ({"policy": "ripple", "reuse_every": 2, "stream_every": 3,
             "steps": 7}, {"default_policy": "svg"}),
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_bucket_key_equals_the_reference(case, tmp_path, clean_state):
    fields, engine_kw = KEY_CASES[case]
    _install_in_both(tmp_path)
    req = {"request_id": 3, "txt": _txt(0), "steps": 3, "seed": 5,
           "latent_shape": (4, 8, 8, 4), **fields}
    got = DiffusionEngine(_factory5, device="cpu",
                          **engine_kw)._bucket_key(GenRequest(**req))
    want = j_engine.DiffusionEngine(
        sampler_factory=_factory5, **engine_kw)._bucket_key(
            j_engine.GenRequest(**req))
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    if "static" in (fields.get("policy"), engine_kw.get("default_policy")):
        assert got[7] is not None


@pytest.mark.parametrize("policy", ["static", "rainfusion", "ripple", None])
def test_pattern_token_equals_the_reference(policy, tmp_path, clean_state):
    assert engine_lib._pattern_token(policy) == \
        j_engine._pattern_token(policy) is None
    art = _install_in_both(tmp_path)
    tok = engine_lib._pattern_token(policy)
    assert tok == j_engine._pattern_token(policy)
    assert tok == (art.version if policy in ("static", "rainfusion")
                   else None)


# ---------------------------------------------------------------------------
# Mixed traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vdit-paper", "dit-xl2", "dit-b2",
                                  "unet-sd15"])
@pytest.mark.parametrize("smoke", [False, True])
def test_mixed_gen_shapes_follow_the_reference(name, smoke):
    got = workloads.mixed_gen_shapes(get_config(name), smoke=smoke)
    want = j_workloads.mixed_gen_shapes(j_get_config(name), smoke=smoke)
    assert [(s.name, s.img_res, s.steps) for s in got] == \
        [(s.name, s.img_res, s.steps) for s in want]
    base = dataclasses.replace(get_config(name).shapes[-1], steps=12)
    j_base = dataclasses.replace(j_get_config(name).shapes[-1], steps=12)
    assert [(s.name, s.img_res, s.steps)
            for s in workloads.mixed_gen_shapes(get_config(name),
                                                base=base)] == \
        [(s.name, s.img_res, s.steps)
         for s in j_workloads.mixed_gen_shapes(j_get_config(name),
                                               base=j_base)]


@pytest.mark.parametrize("name", ["vdit-paper", "dit-xl2", "unet-sd15"])
def test_mixed_request_stream_follows_the_reference(name):
    arch, j_arch = get_config(name), j_get_config(name)
    kw = dict(seed=4, policy="static", reuse_every=2, stream_every=3)
    got = workloads.mixed_request_stream(
        arch, workloads.mixed_gen_shapes(arch), 5, **kw)
    want = j_workloads.mixed_request_stream(
        j_arch, j_workloads.mixed_gen_shapes(j_arch), 5, **kw)
    for (sp, r), (j_sp, jr) in zip(got, want, strict=True):
        assert sp.name == j_sp.name
        np.testing.assert_array_equal(r.txt, jr.txt)
        assert (r.request_id, r.seed, r.steps, r.policy, r.reuse_every,
                r.stream_every, tuple(r.latent_shape)) == \
            (jr.request_id, jr.seed, jr.steps, jr.policy, jr.reuse_every,
             jr.stream_every, tuple(jr.latent_shape))


# ---------------------------------------------------------------------------
# Chunked sampling and the streaming engine
# ---------------------------------------------------------------------------

CACHED = apply_overrides(ARCH, ("ripple.reuse_every=2", "ripple.i_min=0",
                                "ripple.i_max=1"))


@pytest.mark.parametrize("cached", [False, True], ids=["plain", "cache"])
@pytest.mark.parametrize("chunk", [1, 2, 3, 5])
def test_chunks_chain_to_the_monolithic_run(chunk, cached, model):
    """The streamed sampler's chunk j is the trajectory's latents after
    step min((j + 1) K, steps), the last one the monolithic result bit
    for bit, with and without the decision state; the cache counters of
    the last chunk equal the whole run's; each chunk's checkpoint
    (``__ckpt__``) names the step after it and carries the decision
    state exactly when the cache is threaded."""
    arch = CACHED if cached else ARCH
    shape = dataclasses.replace(SHAPE, steps=5)
    whole, _ = serve_lib.build_sampler(arch, shape, model,
                                       compute_dtype=torch.float32)
    streamed, _ = serve_lib.build_sampler(arch, shape, model,
                                          stream_every=chunk,
                                          compute_dtype=torch.float32)
    noise = torch.stack([request_noise(s, LAT, "cpu") for s in (1, 2)])
    txt = torch.from_numpy(np.stack([_txt(1), _txt(2)]))
    want = whole(noise, txt)
    chunks = list(streamed(noise, txt))
    assert len(chunks) == math.ceil(5 / chunk)
    ckpts = [aux.pop("__ckpt__") for _, aux in chunks]
    assert [ck["step"] for ck in ckpts] == \
        [min((j + 1) * chunk, 5) for j in range(len(chunks))]
    assert all((ck["dstate"] is not None) == cached for ck in ckpts)
    if cached:
        want, want_aux = want
        assert {k: int(v) for k, v in chunks[-1][1].items()} == \
            {k: int(v) for k, v in want_aux.items()}
        assert int(want_aux["cache_hits"]) > 0
    else:
        assert chunks[-1][1] == {}
    assert torch.equal(chunks[-1][0], want)
    # Chunk 0 against the first K steps of the same schedule, directly.
    if not cached:
        ddpm = DDPMSchedule()
        cond = {"txt": txt}

        def denoise(x, t, step):
            return workloads._denoise_call(
                arch, model, x, t, cond, step, 5,
                compute_dtype=torch.float32).to(x.dtype)

        first = ddim_sample(denoise, noise, ddpm, min(chunk, 5),
                            total_steps=5)
        assert torch.equal(chunks[0][0], first)


def test_streaming_engine_delivers_chunks_then_the_result(model):
    factory, plan_fn = serve_lib.make_sampler_factory(
        ARCH, (SHAPE,), model, device="cpu", compute_dtype=torch.float32)
    reqs = [GenRequest(request_id=i, txt=_txt(i), latent_shape=LAT,
                       steps=SHAPE.steps, seed=i, stream_every=2)
            for i in range(2)]
    eng = DiffusionEngine(factory, device="cpu", plan_fn=plan_fn)
    for r in reqs:
        eng.submit(r)
    eng.start()
    try:
        chunks = list(eng.stream(0, timeout=300))
        res = [eng.result(r.request_id, timeout=300) for r in reqs]
        # A stream read after its result was consumed still ends, with
        # every chunk.
        late = list(eng.stream(1, timeout=5))
    finally:
        eng.stop()
    assert len(chunks) == len(late) == math.ceil(SHAPE.steps / 2)
    np.testing.assert_array_equal(chunks[-1], res[0].latents)
    np.testing.assert_array_equal(late[-1], res[1].latents)
    assert not np.array_equal(chunks[0], chunks[-1])
    for r in res:
        assert 0 <= r.ttff_s <= r.latency_s
    m = eng.metrics()
    assert m.pop("batches_served") == 1
    assert m and not any(m.values())  # no shed, deadline, retry or trip
    whole = _serve(DiffusionEngine(factory, device="cpu"),
                   [dataclasses.replace(r, stream_every=None) for r in reqs])
    for r, w in zip(res, whole):
        np.testing.assert_array_equal(r.latents, w.latents)
        assert w.ttff_s == pytest.approx(w.latency_s, abs=1e-3)


def test_engine_refuses_what_its_factory_cannot_take():
    req = dict(request_id=0, txt=_txt(0), latent_shape=(2,), steps=2)

    def factory4(shape, steps, policy=None, reuse_every=None):
        return lambda n, t, s: n

    eng = DiffusionEngine(factory4, device="cpu")
    with pytest.raises(ValueError, match="stream_every"):
        eng.submit(GenRequest(**req, stream_every=2))
    eng2 = DiffusionEngine(lambda shape, steps: (lambda n, t, s: n),
                           device="cpu")
    with pytest.raises(ValueError, match="policy"):
        eng2.submit(GenRequest(**req, policy="svg"))
    with pytest.raises(ValueError, match="default_policy"):
        DiffusionEngine(lambda shape, steps: None, device="cpu",
                        default_policy="svg")
    eng3 = DiffusionEngine(_factory5, device="cpu")
    for bad in (0, -1):
        with pytest.raises(ValueError, match="positive"):
            eng3.submit(GenRequest(**req, stream_every=bad))


# ---------------------------------------------------------------------------
# The streamed sampler against the JAX launcher's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [(), ("ripple.reuse_every=2",)],
                         ids=["ripple", "cache"])
def test_streamed_sampler_matches_the_jax_launcher(overrides, monkeypatch):
    """Both launchers' streamed samplers (K = 2 over 3 steps) on the same
    params, noise and text in float32: every chunk within relative L2
    1e-3, and the cache counters of the last chunk equal."""
    sched = ("ripple.i_min=0", "ripple.i_max=1") + overrides
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
    shape = serve_lib.serving_shape(arch, "gen_512", smoke=True)
    j_fn, lat_shape = j_serve.build_sampler(
        j_arch, serve_lib.serving_shape(j_arch, "gen_512", smoke=True),
        jax.tree_util.tree_map(jnp.asarray, tree), stream_every=2)
    fn, _ = serve_lib.build_sampler(
        arch, shape, params_from_numpy(tree, arch.model, device="cpu"),
        stream_every=2, compute_dtype=torch.float32)
    m = arch.model
    noise = rng.standard_normal((2, *lat_shape)).astype(np.float32)
    txt = (0.05 * rng.standard_normal((2, m.txt_tokens, m.txt_dim))).astype(
        np.float32)
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
    want = list(j_fn(jnp.asarray(noise), jnp.asarray(txt), rngs))
    got = list(fn(torch.from_numpy(noise), torch.from_numpy(txt)))
    assert len(got) == len(want) == 2
    for (g, aux), (w, j_aux) in zip(got, want):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) < 1e-3
    for key in ("cache_hits", "cache_refreshes"):
        assert (int(aux[key]) if key in aux else None) == \
            (int(j_aux[key]) if key in j_aux else None), key


# ---------------------------------------------------------------------------
# Per-request policies and the pinned artifact
# ---------------------------------------------------------------------------

def _policy_reqs(policies, seeds, start=0):
    return [GenRequest(request_id=start + i, txt=_txt(seed),
                       latent_shape=LAT, steps=SHAPE.steps, seed=seed,
                       policy=p)
            for i, (p, seed) in enumerate(zip(policies, seeds))]


def test_per_request_policies_get_buckets_of_their_own(model, clean_state):
    """Ripple and static requests in one engine land in two buckets whose
    keys differ in the policy (and its token: static's default template
    has none), each batch served alone; every result equals a
    single-policy engine's, bit for bit."""
    factory, plan_fn = serve_lib.make_sampler_factory(ARCH, (SHAPE,), model,
                                                      device="cpu")
    eng = DiffusionEngine(factory, device="cpu", max_batch=2,
                          plan_fn=plan_fn)
    mixed = _serve(eng, _policy_reqs(["ripple", "static"] * 2, [0, 0, 1, 1]))
    keys = list(eng._compiled)
    assert sorted(k[2] for k in keys) == ["ripple", "static"]
    assert {r.batch_index for r in mixed[0::2]} != \
        {r.batch_index for r in mixed[1::2]}
    for pol, got in (("ripple", mixed[0::2]), ("static", mixed[1::2])):
        alone = _serve(DiffusionEngine(factory, device="cpu", max_batch=2),
                       _policy_reqs([pol] * 2, [0, 1]))
        for g, a in zip(got, alone):
            np.testing.assert_array_equal(g.latents, a.latents)


@pytest.mark.parametrize("policy", ["static", "rainfusion"])
def test_artifact_swap_between_two_steps_keeps_the_batchs_artifact(
        policy, model, tmp_path, clean_state):
    """A denoise hook installs a second artifact before step 1 of a
    served batch: the batch finishes on the artifact it started with
    (its result equals the unswapped run under that artifact, bit for
    bit), and the next request of the policy gets a bucket of its own,
    whose token is the new version and whose result is the new
    artifact's."""
    old = _artifact(patterns)
    new = _artifact(patterns, second=True)
    assert old.version != new.version
    swaps = []

    def hooked(*a, **kw):
        if kw["step"] == 1 and not swaps:
            swaps.append(patterns.set_active_artifact(new))
        return model(*a, **kw)

    def engine(m):
        factory, _ = serve_lib.make_sampler_factory(ARCH, (SHAPE,), m,
                                                    device="cpu")
        return DiffusionEngine(factory, device="cpu")

    patterns.set_active_artifact(new)
    want_new = _serve(engine(model), _policy_reqs([policy], [0]))[0]
    patterns.set_active_artifact(old)
    want_old = _serve(engine(model), _policy_reqs([policy], [0]))[0]
    assert not np.array_equal(want_old.latents, want_new.latents)

    patterns.set_active_artifact(old)
    eng = engine(hooked)
    eng.start()
    try:
        (first,) = _policy_reqs([policy], [0])
        eng.submit(first)
        got = eng.result(first.request_id, timeout=300)
        assert len(swaps) == 1 and patterns.active_artifact() is new
        (nxt,) = _policy_reqs([policy], [0], start=1)
        eng.submit(nxt)
        after = eng.result(nxt.request_id, timeout=300)
    finally:
        eng.stop()
    np.testing.assert_array_equal(got.latents, want_old.latents)
    np.testing.assert_array_equal(after.latents, want_new.latents)
    assert [k[7] for k in eng._compiled] == [old.version, new.version]


@pytest.mark.parametrize("when", ["between_submit_and_serve",
                                  "before_a_rebuild_after_eviction"])
def test_a_bucket_runs_the_artifact_its_key_names(when, model, clean_state):
    """The token and the sampler's artifact are fixed together at submit.
    A swap after a static request was submitted, and before it is
    served, leaves it on the old artifact: either before the worker
    starts, or while a ripple batch runs ahead of it that evicts the
    static sampler (``max_compiled=1``) so that it is built anew."""
    old = _artifact(patterns)
    new = _artifact(patterns, second=True)
    swaps = []

    def hooked(*a, **kw):
        if (when != "between_submit_and_serve" and not swaps
                and kw["ripple"].policy == "ripple"):
            swaps.append(patterns.set_active_artifact(new))
        return model(*a, **kw)

    factory, _ = serve_lib.make_sampler_factory(ARCH, (SHAPE,), hooked,
                                                device="cpu")
    patterns.set_active_artifact(old)
    want_old = _serve(DiffusionEngine(factory, device="cpu"),
                      _policy_reqs(["static"], [0]))[0]
    patterns.set_active_artifact(old)
    if when == "between_submit_and_serve":
        reqs = _policy_reqs(["static"], [0])
    else:
        reqs = _policy_reqs(["static", "ripple", "static"], [1, 0, 0])
    # starve_after_s=0: every head is past its aging bound, so the
    # oldest head is served first and the ripple batch runs between the
    # two static requests.
    eng = DiffusionEngine(factory, device="cpu", max_batch=1,
                          max_compiled=1, starve_after_s=0.0)
    for r in reqs:
        eng.submit(r)
    if when == "between_submit_and_serve":
        swaps.append(patterns.set_active_artifact(new))
    eng.start()
    try:
        got = [eng.result(r.request_id, timeout=300) for r in reqs]
    finally:
        eng.stop()
    assert len(swaps) == 1 and patterns.active_artifact() is new
    # The static request of seed 0 ran after the swap, on the old artifact.
    np.testing.assert_array_equal(got[-1].latents, want_old.latents)
    assert [r.batch_index for r in got] == list(range(len(reqs)))
    assert list(eng._compiled)[-1][7] == old.version


def test_launcher_puts_a_config_policy_and_its_token_in_the_key(
        tmp_path, clean_state, caplog):
    """A pattern policy set only in the config (``ripple.policy=static``,
    no ``--policy``) keys its bucket with the artifact's version, and
    serves what ``--policy static`` serves."""
    path = str(tmp_path / "p.json")
    patterns.save_pattern_artifact(_artifact(patterns), path)
    caplog.set_level("INFO", logger="repro_torch.serve")
    argv = ["--device", "cpu", "--smoke", "--requests", "1", "--shape",
            "gen_512", "--pattern-artifact", path, "model.num_layers=1"]
    by_config = serve_lib.main(argv + ["ripple.policy=static"])
    version = patterns.active_artifact().version
    assert f"'static', None, 1, (8, 64), None, '{version}', 0)" in caplog.text
    by_flag = serve_lib.main(argv + ["--policy", "static"])
    np.testing.assert_array_equal(by_config[0].latents, by_flag[0].latents)


def test_pinned_policy_keeps_its_artifact_and_token(clean_state):
    pol = serve_lib.pinned_policy(ARCH, "static")
    assert pol.name == "static" and pol.plan_token() is None
    with patterns.use_artifact(_artifact(patterns)) as art:
        assert patterns.StaticPatternPolicy().plan_token() == art.version
        assert pol.artifact() is None and pol.plan_token() is None
        held = serve_lib.pinned_policy(ARCH, "rainfusion")
    assert held.artifact() is art and held.plan_token() == art.version
    assert serve_lib.pinned_policy(ARCH, "svg") == "svg"
    assert serve_lib.pinned_policy(ARCH) is None


# ---------------------------------------------------------------------------
# The launcher's flags
# ---------------------------------------------------------------------------

def _reference_summary_keys():
    """The keys of the reference launcher's ``--summary-json`` dict, read
    from its source."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" /
                      "serve.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "summary"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no summary dict in the reference launcher")


def test_launcher_streams_mixed_buckets_and_writes_its_summary(tmp_path,
                                                               caplog):
    """Positional overrides, mixed buckets under ``--max-compiled 1``
    (each new bucket evicts the last sampler), ``--stream-every`` and
    ``--summary-json`` with the reference's keys."""
    import json

    caplog.set_level("INFO")
    path = tmp_path / "s.json"
    done = serve_lib.main(["--device", "cpu", "--smoke", "--requests", "3",
                           "--max-compiled", "1", "--stream-every", "2",
                           "--summary-json", str(path), "model.num_layers=1"])
    assert [r.latents.shape for r in done] == [
        (4, 8, 8, 4), (4, 4, 4, 4), (4, 8, 8, 4)]
    assert "vdit-paper-smoke (1 layers)" in caplog.text
    assert caplog.text.count("evicted the sampler of bucket") == 2
    assert caplog.text.count("(2 chunks)") == 2  # 3 steps; the s2 bucket 1
    assert "(1 chunks)" in caplog.text
    for r in done:
        assert 0 <= r.ttff_s <= r.latency_s
    summary = json.loads(path.read_text())
    assert set(summary) == _reference_summary_keys()
    assert summary["completed"] == summary["submitted"] == [0, 1, 2]
    counters = summary["counters"]
    assert counters.pop("batches_served") == 3
    # Guardrails are on by default: the ladder's counters are there, and
    # nothing shed, tripped, retried or degraded.
    assert {"shed_count", "watchdog_trips", "degraded_count",
            "dense_fallbacks"} <= set(counters)
    assert not any(counters.values())
    assert (summary["errors"], summary["shed"], summary["sigterm"]) == \
        ({}, 0, False)


def test_launcher_imports_a_policy_module(tmp_path, monkeypatch, caplog):
    (tmp_path / "engine_test_policy.py").write_text(
        "from repro_torch.core.policy import DensePolicy, register_policy\n"
        "\n"
        "class _Plain(DensePolicy):\n"
        "    name = 'engine_test_dense'\n"
        "\n"
        "register_policy(_Plain(), override=True)\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    caplog.set_level("INFO")
    done = serve_lib.main(["--device", "cpu", "--smoke", "--requests", "1",
                           "--policy-module", "engine_test_policy",
                           "--policy", "engine_test_dense",
                           "model.num_layers=1"])
    assert len(done) == 1 and np.isfinite(done[0].latents).all()
    assert "attention[engine_test_dense/dense " in caplog.text


def test_launcher_refuses_an_unknown_policy():
    with pytest.raises(SystemExit):
        serve_lib.main(["--device", "cpu", "--smoke", "--policy",
                        "no_such_policy"])


def test_launcher_drift_tol_is_the_config_field(caplog):
    """``--drift-tol`` sets ``ripple.drift_tol``: the same latents as the
    override, the cache threaded (every step refreshes at R = 1)."""
    caplog.set_level("INFO", logger="repro_torch.serve")
    argv = ["--device", "cpu", "--smoke", "--requests", "1",
            "model.num_layers=1"]
    flag = serve_lib.main(argv + ["--drift-tol", "0.1"])
    override = serve_lib.main(argv + ["--override", "ripple.drift_tol=0.1"])
    np.testing.assert_array_equal(flag[0].latents, override[0].latents)
    # 1 layer x 1 request x 2 heads, 3 steps.
    assert caplog.text.count("decision cache: 0 hits / 6 refreshes") == 2

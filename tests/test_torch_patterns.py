"""The port's offline-pattern slice (``core/patterns.py``,
``launch/pattern_search.py``, the ``static`` and ``rainfusion``
policies) against the JAX package on inputs made with numpy from a seed:
template keeps and block maps bit for bit, the artifact file read and
written across the two packages with one version, the search's verdicts
on the same samples, both policies through the dispatch seam and the
decision cache, the constant-plan store and its bound, the launchers on
the CPU, and an artifact swap served through one engine."""

import dataclasses
import gc
import json
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import RippleConfig as JRippleConfig  # noqa: E402
from repro.config.base import apply_overrides as j_apply_overrides  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core import dispatch as j_dispatch  # noqa: E402
from repro.core import patterns as j_patterns  # noqa: E402
from repro.launch import pattern_search as j_pattern_search  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.launch import workloads as j_workloads  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.models.vdit import vdit_defs  # noqa: E402
from repro_torch.config.base import RippleConfig, apply_overrides  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import dispatch, patterns  # noqa: E402
from repro_torch.core.policy import get_policy, replay_snap  # noqa: E402
from repro_torch.kernels.sparse import ops as sparse_ops  # noqa: E402
from repro_torch.launch import pattern_search  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models.params import init_vdit, params_from_numpy  # noqa: E402
from repro_torch.serving.engine import (DiffusionEngine, GenRequest,  # noqa: E402
                                        request_noise)

torch.set_num_threads(2)

GRIDS = [(4, 8, 8), (1, 16, 16), (8, 4, 4)]
BLOCKS = [(32, 32), (64, 32), (128, 128)]
N_TXT = 8


def _toy_heads(mod, grid=(4, 8, 8), block=(32, 32)):
    """Head 0 static frame-diagonal, head 1 static spatial, head 2
    dynamic, built from ``mod`` (either package's patterns module)."""
    t_spec = mod.template("frame_diag", window=1, sink=1)
    s_spec = mod.template("spatial_local", radius=1)
    return {
        (0, 0): mod.HeadAssignment(
            spec=t_spec, static=True, branch="spatial", psnr_db=40.0,
            skip_rate=mod.template_skip_rate(t_spec, grid, block),
            stability=1.0),
        (0, 1): mod.HeadAssignment(
            spec=s_spec, static=True, branch="spatial", psnr_db=35.123,
            skip_rate=mod.template_skip_rate(s_spec, grid, block),
            stability=1.0),
        (0, 2): mod.HeadAssignment(
            spec=mod.template("dense"), static=False, branch="dynamic",
            psnr_db=0.0, skip_rate=0.0, stability=0.4),
    }


def _toy(mod, grid=(4, 8, 8), block=(32, 32)):
    return mod.PatternArtifact(grid=grid, block_shape=block,
                               tolerance_db=30.0,
                               heads=_toy_heads(mod, grid, block),
                               meta={"traffic": "toy"})


@pytest.fixture
def clean_state():
    """No active artifact in either package, before and after, and no
    stored plans or cached dispatch plans left behind."""
    patterns.clear_plans()
    with patterns.use_artifact(None), j_patterns.use_artifact(None):
        yield
    patterns.clear_plans()
    j_dispatch.clear_plan_cache()


# ---------------------------------------------------------------------------
# Templates, keeps and block maps
# ---------------------------------------------------------------------------

def test_tile_states_equal_the_sparse_kernels():
    assert (patterns._SKIP, patterns._FULL, patterns._PARTIAL) == \
        (sparse_ops.SKIP, sparse_ops.FULL, sparse_ops.PARTIAL)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("pasted", [False, True], ids=["grid", "text+grid"])
def test_bank_keeps_and_block_maps_bit_equal_to_jax(grid, pasted):
    """Every template of the grid's default bank: the keep (with and
    without text tokens pasted around the grid) and its block map at
    three block shapes."""
    bank = patterns.default_bank(grid)
    assert [s.label for s in bank] == \
        [s.label for s in j_patterns.default_bank(grid)]
    assert patterns.default_template(grid).label == \
        j_patterns.default_template(grid).label
    n = int(np.prod(grid))
    n_tok = n + 2 * N_TXT if pasted else n
    gs = (N_TXT, n) if pasted else None
    for spec, j_spec in zip(bank, j_patterns.default_bank(grid)):
        keep = patterns._paste(patterns.render_keep(spec, grid), n_tok, gs)
        want = j_patterns._paste_grid_slice(
            j_patterns.render_keep(j_spec, grid)[None], n_tok, gs)[0]
        np.testing.assert_array_equal(keep, want, err_msg=spec.label)
        for blk in BLOCKS:
            np.testing.assert_array_equal(
                patterns.block_map_np(keep, *blk),
                j_patterns.block_map_np(want, *blk), err_msg=spec.label)
        assert patterns.branch_of(spec) == j_patterns.branch_of(j_spec)
        assert patterns.template_skip_rate(spec, grid, (32, 32)) == \
            j_patterns.template_skip_rate(j_spec, grid, (32, 32))


def test_unknown_family_and_malformed_spec_raise():
    with pytest.raises(ValueError, match="unknown template family"):
        patterns.template("bogus")
    with pytest.raises(ValueError, match="malformed"):
        patterns.TemplateSpec.from_json({"params": {}})


# ---------------------------------------------------------------------------
# The artifact file across the two packages
# ---------------------------------------------------------------------------

def test_artifacts_of_equal_content_have_one_version():
    art, j_art = _toy(patterns), _toy(j_patterns)
    assert art.to_json() == j_art.to_json()
    assert art.version == j_art.version


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_artifact_written_by_one_package_loads_in_the_other(writer,
                                                            tmp_path):
    path = str(tmp_path / "patterns.json")
    src, dst = (patterns, j_patterns) if writer == "port" \
        else (j_patterns, patterns)
    art = _toy(src)
    src.save_pattern_artifact(art, path)
    got = dst.load_pattern_artifact(path)
    assert got.version == art.version
    assert got.heads.keys() == art.heads.keys()
    for key, a in art.heads.items():
        assert got.heads[key].to_json() == a.to_json()
    assert got.static_fraction() == art.static_fraction()


def test_artifact_routing_and_keep_equal_jax():
    art, j_art = _toy(patterns), _toy(j_patterns)
    for layer in (None, 0, 3):
        assert art.branches(4, layer) == j_art.branches(4, layer)
        np.testing.assert_array_equal(
            art.keep_for((4, 8, 8), 4, layer),
            j_art.keep_for((4, 8, 8), 4, layer))


def test_corrupt_schema_and_missing_files(tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_bytes(b"\x00not json")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert patterns.load_pattern_artifact(str(bad)) is None
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"schema": "repro-pattern/0"}))
    with pytest.warns(RuntimeWarning, match="schema"):
        assert patterns.load_pattern_artifact(str(other)) is None
    assert patterns.load_pattern_artifact(str(tmp_path / "none.json")) \
        is None
    with pytest.raises(ValueError, match="no usable pattern artifact"):
        patterns.install_artifact(str(tmp_path / "none.json"))
    monkeypatch.setenv("REPRO_PATTERN_ARTIFACT", str(tmp_path / "env.json"))
    assert patterns.pattern_artifact_path() == \
        j_patterns.pattern_artifact_path() == str(tmp_path / "env.json")


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

# The port scores in torch, the reference in JAX, both f32: the PSNRs of
# one sample differ by the summation order of two attention outputs and
# of the mean square error, well below a hundredth of a dB.
PSNR_TOL_DB = 0.01


@pytest.mark.parametrize("grid,chars", [
    ((4, 8, 8), ("temporal", "spatial", "dynamic")),
    ((8, 4, 4), ("temporal", "spatial"))])
def test_search_on_jax_samples_matches_jax(grid, chars):
    """The same (JAX-made) calibration samples through both searches:
    every head's template, verdict, branch, skip rate and stability are
    equal, its worst PSNR within PSNR_TOL_DB."""
    samples = [(layer, np.array(q), np.array(k), np.array(v))
               for layer, q, k, v in j_pattern_search.calibration_traffic(
                   grid=grid, layers=2, heads=3, steps=2, prompts=1, d=16,
                   characters=chars)]
    kw = dict(block_shape=(32, 32), tolerance_db=20.0, meta={"t": 1})
    want = j_patterns.search_patterns(
        [(l, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
         for l, q, k, v in samples], grid, **kw)
    got = patterns.search_patterns(
        [(l, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
         for l, q, k, v in samples], grid, **kw)
    assert got.heads.keys() == want.heads.keys()
    for key, a in want.heads.items():
        b = got.heads[key]
        assert (b.spec.label, b.static, b.branch, b.skip_rate,
                b.stability) == (a.spec.label, a.static, a.branch,
                                 a.skip_rate, a.stability), key
        assert b.psnr_db == pytest.approx(a.psnr_db, abs=PSNR_TOL_DB), key
    assert got.meta == want.meta
    assert 0.0 < got.static_fraction() <= 1.0


def test_pattern_search_cli_writes_a_loadable_artifact(tmp_path, capsys,
                                                      monkeypatch):
    path = str(tmp_path / "p.json")
    art = pattern_search.main([
        "--device", "cpu", "--grid", "4x8x8", "--layers", "1", "--heads",
        "3", "--d", "16", "--prompts", "1", "--block", "32x32",
        "--tolerance-db", "20", "--out", path])
    out = capsys.readouterr().out
    assert out.count("L0/H") == 3
    assert f"version {art.version}" in out and f"wrote {path}" in out
    assert j_patterns.load_pattern_artifact(path).version == art.version
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pattern_search.main(["--out", path])


# ---------------------------------------------------------------------------
# The policies through dispatch
# ---------------------------------------------------------------------------

GRID = (4, 8, 8)
N = 256
KW = dict(enabled=True, theta_min=0.2, theta_max=0.5, i_min=1, i_max=4)


def _np_qkv(seed, n=N, heads=3, d=16, batch=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((batch, heads, n, d)).astype(np.float32)
                 for _ in range(3))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


CASES = {
    "static-default": ("static", False, None),
    "static-artifact": ("static", True, None),
    "static-artifact-text": ("static", True, (N_TXT, N)),
    "static-artifact-reference": ("static", True, None),
    "rainfusion-artifact": ("rainfusion", True, None),
    "rainfusion-artifact-text": ("rainfusion", True, (N_TXT, N)),
    "rainfusion-none": ("rainfusion", False, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_matches_jax(case, clean_state):
    """f32: relative L2 below 1e-5 (summation order only: the JAX sparse
    kernel in interpret mode sums online over tiles, the port's plain
    version at once); savings and block maps equal."""
    policy, with_art, gs = CASES[case]
    backend = "reference" if case.endswith("reference") else None
    n = N + 2 * N_TXT if gs else N
    q, k, v = _np_qkv(3, n)
    cfg, j_cfg = RippleConfig(policy=policy, **KW), \
        JRippleConfig(policy=policy, **KW)
    art, j_art = (_toy(patterns), _toy(j_patterns)) if with_art \
        else (None, None)
    with patterns.use_artifact(art), j_patterns.use_artifact(j_art):
        kw = dict(grid=GRID, step=2, total_steps=6, grid_slice=gs,
                  backend=backend)
        want = np.asarray(j_dispatch.attention_dispatch(
            *(jnp.asarray(a) for a in (q, k, v)), cfg=j_cfg, **kw))
        got = dispatch.attention_dispatch(
            *(torch.from_numpy(a) for a in (q, k, v)), cfg=cfg, **kw).numpy()
        assert _rel(got, want) < 1e-5
        plan = dispatch.resolve_plan(q.shape, v.shape, cfg, on_cuda=False,
                                     backend=backend)
        assert plan.backend == (backend or "sparse")
        if plan.backend == "sparse":
            pol, j_pol = get_policy(policy), j_dispatch.get_policy(policy)
            thetas = pol.thetas_for(cfg, 2, 6)
            blk = (plan.block_q, plan.block_k)
            d = pol.decide(torch.from_numpy(q), torch.from_numpy(k),
                           grid=GRID, cfg=cfg, thetas=thetas, grid_slice=gs,
                           block_shape=blk)
            jd = j_pol.decide(jnp.asarray(q), jnp.asarray(k), grid=GRID,
                              cfg=j_cfg,
                              thetas=j_pol.thetas_for(j_cfg, jnp.asarray(2),
                                                      6),
                              grid_slice=gs, block_shape=blk)
            assert float(d.savings) == pytest.approx(float(jd.savings),
                                                     abs=1e-6)
            if jd.block_map is None:
                assert d.block_map is None
            else:
                np.testing.assert_array_equal(
                    d.block_map.numpy(),
                    np.broadcast_to(np.asarray(jd.block_map),
                                    d.block_map.shape))
            assert (d.bias is None) == (jd.bias is None)


@pytest.mark.parametrize("policy", ["static", "rainfusion"])
def test_decision_cache_matches_jax(policy, clean_state):
    """Six steps under ``ripple.reuse_every=2`` through the decision
    cache, the toy artifact installed in both packages: outputs at every
    step within 1e-5 relative L2, and the same hit and refresh counters
    (static plans once: one refresh, then hits)."""
    q, k, v = _np_qkv(5)
    kw = dict(KW, policy=policy, reuse_every=2)
    cfg, j_cfg = RippleConfig(**kw), JRippleConfig(**kw)
    cache = j_cache = None
    with patterns.use_artifact(_toy(patterns)), \
            j_patterns.use_artifact(_toy(j_patterns)):
        for step in range(6):
            out, cache = dispatch.attention_dispatch(
                *(torch.from_numpy(a) for a in (q, k, v)), grid=GRID,
                cfg=cfg, step=step, total_steps=6, cached_decision=cache,
                return_decision=True)
            j_out, j_cache = j_dispatch.attention_dispatch(
                *(jnp.asarray(a) for a in (q, k, v)), grid=GRID,
                cfg=j_cfg, step=jnp.asarray(step), total_steps=6,
                cached_decision=j_cache, return_decision=True)
            assert _rel(out.numpy(), np.asarray(j_out)) < 1e-5, step
            np.testing.assert_array_equal(cache.hits.numpy(),
                                          np.asarray(j_cache.hits))
            np.testing.assert_array_equal(cache.refreshes.numpy(),
                                          np.asarray(j_cache.refreshes))
    assert int(cache.refreshes.max()) == (1 if policy == "static" else 4)


def test_rainfusion_static_heads_replay_identity_sources(clean_state):
    """Under the cache a rainfusion plan carries identity snap sources
    for its static heads: replaying it leaves those heads' operands
    untouched and unmasked, while the dynamic head snaps."""
    q, k, _ = (torch.from_numpy(a) for a in _np_qkv(7))
    cfg = RippleConfig(policy="rainfusion", **KW)
    pol = get_policy("rainfusion")
    with patterns.use_artifact(_toy(patterns)):
        d = pol.decide(q, k, grid=GRID, cfg=cfg,
                       thetas=pol.thetas_for(cfg, 3, 6), want_plan=True,
                       block_shape=(128, 128))
    own = torch.arange(N, dtype=d.q_src.dtype)[:, None].expand(
        d.q_src.shape[-2:])
    for h in (0, 1):
        assert torch.equal(d.q_src[:, h], own.expand_as(d.q_src[:, h]))
        assert torch.equal(d.q[:, h], q[:, h])
    assert d.q_mask[:, 2].any()  # the dynamic head snapped
    fresh = q + 0.5
    replayed, mask = replay_snap(fresh, d.q_src, None, True)
    assert torch.equal(replayed[:, :2], fresh[:, :2])
    assert not mask[:, :2].any()


def test_constant_plans_are_built_once_per_key(clean_state):
    """``static`` builds its plan once per key and hands it out after:
    the same tensors on every call, a new build only for a new block
    shape or artifact; a PARTIAL-free map carries no bias at all."""
    q, k, _ = (torch.from_numpy(a) for a in _np_qkv(9))
    cfg = RippleConfig(policy="static", **KW)
    pol = get_policy("static")
    th = pol.thetas_for(cfg, 0, 2)
    before = patterns.plan_builds
    d1 = pol.decide(q, k, grid=GRID, cfg=cfg, thetas=th,
                    block_shape=(128, 128))
    d2 = pol.decide(q + 1, k, grid=GRID, cfg=cfg, thetas=th,
                    block_shape=(128, 128))
    assert patterns.plan_builds == before + 1
    assert d1.block_map is d2.block_map and d1.bias is d2.bias
    pol.decide(q, k, grid=GRID, cfg=cfg, thetas=th, block_shape=(32, 32))
    assert patterns.plan_builds == before + 2
    # frame_diag on 16-token frames tiled by 16: every tile FULL or SKIP
    d3 = pol.decide(q, k, grid=GRID, cfg=cfg, thetas=th,
                    block_shape=(64, 64))
    assert not (d3.block_map == sparse_ops.PARTIAL).any()
    assert d3.bias is None and patterns.plan_builds == before + 3
    with patterns.use_artifact(_toy(patterns)) as art:
        pol.decide(q, k, grid=GRID, cfg=cfg, thetas=th,
                   block_shape=(128, 128))
    assert patterns.plan_builds == before + 4
    # The swap kept the older plans, each under its own version.
    assert [k[1] for k in patterns.plan_store()] == [None] * 3 + [art.version]


def test_plan_store_evicts_the_oldest_plan_past_its_budget(clean_state,
                                                         monkeypatch):
    """The store is an LRU bounded by bytes: a second key whose plan does
    not fit beside the first evicts it, and the first plan's bias is
    released; a lookup that hits hands out the same tensors, the
    rainfusion head mask among them."""
    q, k, _ = (torch.from_numpy(a) for a in _np_qkv(10))
    cfg = RippleConfig(policy="rainfusion", **KW)
    pol = get_policy("rainfusion")
    th = pol.thetas_for(cfg, 3, 6)
    plan_bytes = 3 * N * N * 4 + 3 * 2 * 2 * 4  # the bias and a 2 x 2 map
    monkeypatch.setattr(patterns, "_PLAN_STORE_BYTES", plan_bytes)
    with patterns.use_artifact(_toy(patterns)):
        pol.decide(q, k, grid=GRID, cfg=cfg, thetas=th,
                   block_shape=(128, 128))
        (first,) = patterns.plan_store().values()
        assert first.bias is not None and first.nbytes == plan_bytes
        assert first.dynamic.flatten().tolist() == [False, False, True]
        pol.decide(q, k, grid=GRID, cfg=cfg, thetas=th,
                   block_shape=(128, 128))
        assert list(patterns.plan_store().values()) == [first]
        released = weakref.ref(first.bias)
        del first
        pol.decide(q, k, grid=GRID, cfg=cfg, thetas=th,
                   block_shape=(64, 64))
        (second,) = patterns.plan_store().values()
        assert second.block_map.shape == (3, 4, 4)
        gc.collect()
        assert released() is None


def test_artifact_swap_reaches_a_served_bucket(clean_state):
    """One engine serves the same request before and after an artifact
    swap: the bucket's sampler is built once, and the second result is
    the new artifact's (a fresh sampler under it gives the same latents)
    and not the old one's."""
    arch = apply_overrides(T_ARCH, ("model.num_layers=1",))
    shape = serve_lib.serving_shape(arch, "gen_512", smoke=True, steps=2)
    model = init_vdit(arch.model, seed=0, device="cpu", zero_init=False)
    built = []

    def factory(shp, steps):
        built.append(shp)
        return serve_lib.build_sampler(arch, shape, model,
                                       policy="static")[0]

    lat_shape = serve_lib.latent_shape_for(arch, shape)
    txt = np.random.default_rng(3).standard_normal(
        (arch.model.txt_tokens, arch.model.txt_dim)).astype(np.float32)
    old = _smoke_artifact(patterns)
    heads = dict(old.heads)
    heads[(0, 1)] = patterns.HeadAssignment(
        patterns.template("spatial_local", radius=1), True, "spatial", 40.0,
        0.0, 1.0)
    new = dataclasses.replace(old, heads=heads)
    assert new.version != old.version
    eng = DiffusionEngine(factory, device="cpu")
    eng.start()
    served = []
    try:
        for i, art in enumerate((old, new)):
            patterns.set_active_artifact(art)
            eng.submit(GenRequest(request_id=i, txt=txt,
                                  latent_shape=lat_shape,
                                  steps=shape.steps, seed=7))
            served.append(eng.result(i).latents)
    finally:
        eng.stop()
    assert len(built) == 1
    fresh = serve_lib.build_sampler(arch, shape, model, policy="static")[0](
        request_noise(7, lat_shape, "cpu")[None],
        torch.from_numpy(txt)[None]).numpy()[0]
    np.testing.assert_array_equal(served[1], fresh)
    assert not np.array_equal(served[0], served[1])


def test_rainfusion_without_artifact_equals_ripple(clean_state):
    """No artifact: every head dynamic, no map (all tiles run), the
    ripple decision exactly."""
    q, k, v = (torch.from_numpy(a) for a in _np_qkv(13))
    kw = dict(grid=GRID, step=2, total_steps=6, backend="reference")
    out_rf = dispatch.attention_dispatch(
        q, k, v, cfg=RippleConfig(policy="rainfusion", **KW), **kw)
    out_rp = dispatch.attention_dispatch(
        q, k, v, cfg=RippleConfig(policy="ripple", **KW), **kw)
    assert torch.equal(out_rf, out_rp)


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

J_ARCH = j_smoke_config("vdit-paper")
T_ARCH = get_smoke_config("vdit-paper")
SMOKE_GRID = (4, 4, 4)  # the smoke vdit at 64²: 4 frames of 4 x 4 tokens


def _smoke_artifact(mod):
    """A hand-built artifact at the smoke vdit's grid: head 0 static on a
    frame-diagonal window, head 1 dynamic."""
    spec = mod.template("frame_diag", window=1, sink=1)
    heads = {(0, 0): mod.HeadAssignment(spec, True, "spatial", 40.0,
                                        0.0, 1.0),
             (0, 1): mod.HeadAssignment(mod.template("dense"), False,
                                        "dynamic", 0.0, 0.0, 0.5)}
    return mod.PatternArtifact(grid=SMOKE_GRID, block_shape=(32, 32),
                               tolerance_db=25.0, heads=heads)


@pytest.mark.parametrize("policy,with_art", [("static", False),
                                             ("rainfusion", True)])
def test_serve_cli_on_cpu(policy, with_art, tmp_path, caplog, clean_state):
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    argv = ["--device", "cpu", "--smoke", "--requests", "1", "--policy",
            policy, "--override", "model.num_layers=1"]
    if with_art:
        path = str(tmp_path / "p.json")
        art = patterns.save_pattern_artifact(_smoke_artifact(patterns), path)
        argv += ["--pattern-artifact", art]
    done = serve_lib.main(argv)
    assert len(done) == 1 and np.isfinite(done[0].latents).all()
    assert f"attention[{policy}/sparse block=128x128" in caplog.text
    if with_art:
        assert ("pattern artifact "
                f"{_smoke_artifact(patterns).version}: 2 heads, 50% static"
                in caplog.text)


@pytest.fixture(scope="module")
def vdit_tree():
    rng = np.random.default_rng(5)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(
            a.shape[-2] if a.ndim > 1 else 1) + (a.ndim == 1)).astype(
                np.float32),
        init_params(vdit_defs(J_ARCH.model), jax.random.PRNGKey(0)))


@pytest.mark.parametrize("policy", ["static", "rainfusion"])
def test_sampler_matches_the_jax_launcher(policy, vdit_tree, tmp_path,
                                          monkeypatch, clean_state):
    """Both launchers' samplers under ``policy`` (the smoke artifact
    written by the port, read by each package's ``install_artifact``),
    3 DDIM steps in float32 on the same params, noise and text: relative
    L2 below 1e-3."""
    path = str(tmp_path / "p.json")
    patterns.save_pattern_artifact(_smoke_artifact(patterns), path)
    overrides = ("ripple.i_min=0", "ripple.i_max=2")
    j_arch = j_apply_overrides(J_ARCH, overrides)
    arch = apply_overrides(T_ARCH, overrides)
    orig = j_workloads.vdit_lib.vdit_apply
    monkeypatch.setattr(j_workloads.vdit_lib, "vdit_apply",
                        lambda *a, **kw: orig(*a, compute_dtype=jnp.float32,
                                              **kw))
    shape = serve_lib.serving_shape(arch, "gen_512", smoke=True)
    j_shape = serve_lib.serving_shape(j_arch, "gen_512", smoke=True)
    assert patterns.install_artifact(path).version == \
        j_patterns.install_artifact(path).version
    j_fn, lat_shape = j_serve.build_sampler(
        j_arch, j_shape, jax.tree_util.tree_map(jnp.asarray, vdit_tree),
        policy=policy)
    fn, _ = serve_lib.build_sampler(
        arch, shape, params_from_numpy(vdit_tree, arch.model, device="cpu"),
        policy=policy, compute_dtype=torch.float32)
    rng = np.random.default_rng(6)
    m = arch.model
    noise = rng.standard_normal((2, *lat_shape)).astype(np.float32)
    txt = (0.05 * rng.standard_normal((2, m.txt_tokens, m.txt_dim))).astype(
        np.float32)
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
    want = np.asarray(j_fn(jnp.asarray(noise), jnp.asarray(txt), rngs))
    got = fn(torch.from_numpy(noise), torch.from_numpy(txt)).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) < 1e-3


def test_new_modules_join_the_import_scan():
    """The AST scan of tests/test_torch_serve.py walks every port module;
    this slice's are among them."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "src" / \
        "repro_torch"
    files = {p.relative_to(root).as_posix() for p in root.rglob("*.py")}
    assert {"core/patterns.py", "launch/pattern_search.py"} <= files

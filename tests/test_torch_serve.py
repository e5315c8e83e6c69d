"""The port's serving stack on the CPU, and its import rule: the engine
returns what a direct sampler call gives on the same per-request noise,
the launcher answers its requests with ``--device cpu`` and refuses to
run without a card otherwise, and nothing in the port imports JAX or the
JAX package."""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch.workloads import mixed_request_stream  # noqa: E402
from repro_torch.models.params import init_vdit  # noqa: E402
from repro_torch.serving.engine import (DiffusionEngine,  # noqa: E402
                                        GenRequest, request_noise)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_engine_result_equals_direct_sampler_call():
    arch = get_smoke_config("vdit-paper")
    shape = serve_lib.serving_shape(arch, "gen_512", smoke=True)
    model = init_vdit(arch.model, seed=3, device="cpu", zero_init=False)
    fn, lat_shape = serve_lib.build_sampler(arch, shape, model,
                                            compute_dtype=torch.float32)
    # A long linger keeps the batching deterministic on a loaded machine:
    # requests 0-1 always share a batch, request 2 runs alone.
    engine = DiffusionEngine(lambda shp, steps: fn, device="cpu",
                             max_batch=2, max_wait_s=0.5)
    traffic = mixed_request_stream(arch, (shape,), 3, seed=4)
    engine.start()
    try:
        for _, req in traffic:
            engine.submit(req)
        results = [engine.result(req.request_id) for _, req in traffic]
    finally:
        engine.stop()
    assert {r.batch_index for r in results} == {0, 1}  # batches of 2 and 1
    for bi in (0, 1):
        # Replay each batch directly: same requests, same order, same noise.
        batch = [(req, res) for (_, req), res in zip(traffic, results)
                 if res.batch_index == bi]
        noise = torch.stack([request_noise(req.seed, lat_shape, "cpu")
                             for req, _ in batch])
        txt = torch.stack([torch.from_numpy(req.txt) for req, _ in batch])
        direct = fn(noise, txt).numpy()
        for i, (_, res) in enumerate(batch):
            assert res.latents.shape == lat_shape
            np.testing.assert_array_equal(res.latents, direct[i])
    assert not np.allclose(results[0].latents, results[1].latents)


def test_request_noise_is_per_seed():
    a = request_noise(7, (2, 3), "cpu")
    assert torch.equal(a, request_noise(7, (2, 3), "cpu"))
    assert not torch.equal(a, request_noise(8, (2, 3), "cpu"))


def test_main_serves_on_cpu():
    """Without ``--shape`` the traffic is mixed: request 0 at the base
    64² shape, request 1 at its half resolution."""
    done = serve_lib.main(["--device", "cpu", "--smoke", "--requests", "2",
                           "--override", "model.num_layers=1"])
    assert [r.request_id for r in done] == [0, 1]
    assert [r.latents.shape for r in done] == [(4, 8, 8, 4), (4, 4, 4, 4)]
    for r in done:
        assert np.isfinite(r.latents).all()


@pytest.mark.parametrize("args,plan", [
    (["--policy", "svg"], "attention[svg/sparse block=128x128"),
    (["--override", "ripple.svg_mask=true"],
     "attention[ripple/sparse block=128x128"),
])
def test_main_serves_the_svg_paths_on_cpu(args, plan, caplog):
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    done = serve_lib.main(["--device", "cpu", "--smoke", "--requests", "1",
                           "--override", "model.num_layers=1", *args])
    assert len(done) == 1 and np.isfinite(done[0].latents).all()
    assert plan in caplog.text


def test_main_serves_through_the_collapse_backend_on_cpu(caplog):
    """``--attn-backend collapse`` (the reference launcher's flag) serves
    through the exact pair-collapse backend."""
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    done = serve_lib.main(["--device", "cpu", "--smoke", "--requests", "1",
                           "--override", "model.num_layers=1",
                           "--attn-backend", "collapse"])
    assert len(done) == 1 and np.isfinite(done[0].latents).all()
    assert "attention[ripple/collapse " in caplog.text


# The two decision-cache settings the launcher serves on the vdit: the
# ripple policy at a cadence of 2, and svg under the drift guard.  The
# schedule snaps from step 0 (i_min 0) so that hit steps replay snaps.
CACHE_SETTINGS = {
    "ripple-reuse_every": (None, ("ripple.reuse_every=2",)),
    "svg-drift_tol": ("svg", ("ripple.drift_tol=0.1",)),
}
CACHE_SCHEDULE = ("ripple.i_min=0", "ripple.i_max=1")


@pytest.mark.parametrize("setting", sorted(CACHE_SETTINGS))
def test_main_serves_decision_cache_settings(setting, caplog):
    """The launcher serves the vdit under the cache and logs its
    counters: per (layer, batch, head) cell, 3 steps at R=2 make 2
    refreshes (step 0 and the final step) and 1 hit; under the drift
    guard alone (R=1) every step refreshes."""
    policy, overrides = CACHE_SETTINGS[setting]
    caplog.set_level("INFO", logger="repro_torch.serve")
    argv = ["--device", "cpu", "--smoke", "--requests", "2", "--shape",
            "gen_512"]
    argv += ["--policy", policy] if policy else []
    for o in overrides + CACHE_SCHEDULE:
        argv += ["--override", o]
    done = serve_lib.main(argv)
    assert [r.request_id for r in done] == [0, 1]
    assert all(np.isfinite(r.latents).all() for r in done)
    cells = 2 * 2 * 2  # layers x batch x heads of the smoke vdit
    hits, refr = (1, 2) if setting == "ripple-reuse_every" else (0, 3)
    assert (f"decision cache: {hits * cells} hits / {refr * cells} "
            f"refreshes") in caplog.text


@pytest.mark.parametrize("setting", sorted(CACHE_SETTINGS))
def test_cached_sampler_matches_the_jax_launcher(setting, monkeypatch):
    """The port's and the JAX launcher's samplers under the same cache
    setting, on the same params, noise and text, in float32: the latents
    agree within the f32 summation-order gap (relative L2 < 1e-3) and the
    decision-cache counters are equal."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as j_smoke_config
    from repro.config.base import apply_overrides as j_apply_overrides
    from repro.launch import serve as j_serve
    from repro.launch import workloads as j_workloads
    from repro.models.params import init_params
    from repro.models.vdit import vdit_defs
    from repro_torch.config.base import apply_overrides
    from repro_torch.models.params import params_from_numpy

    policy, overrides = CACHE_SETTINGS[setting]
    j_arch = j_apply_overrides(j_smoke_config("vdit-paper"),
                               overrides + CACHE_SCHEDULE)
    arch = apply_overrides(get_smoke_config("vdit-paper"),
                           overrides + CACHE_SCHEDULE)
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(
            a.shape[-2] if a.ndim > 1 else 1) + (a.ndim == 1)).astype(
                np.float32),
        init_params(vdit_defs(j_arch.model), jax.random.PRNGKey(0)))
    shape = serve_lib.serving_shape(arch, "gen_512", smoke=True)
    j_shape = serve_lib.serving_shape(j_arch, "gen_512", smoke=True)
    # The JAX launcher computes in its model's default bf16; pin f32 on
    # both sides so the comparison measures the cache, not bf16 rounding.
    orig = j_workloads.vdit_lib.vdit_apply
    monkeypatch.setattr(j_workloads.vdit_lib, "vdit_apply",
                        lambda *a, **kw: orig(*a, compute_dtype=jnp.float32,
                                              **kw))
    j_fn, lat_shape = j_serve.build_sampler(j_arch, j_shape,
                                            jax.tree_util.tree_map(
                                                jnp.asarray, tree),
                                            policy=policy)
    fn, t_lat_shape = serve_lib.build_sampler(
        arch, shape, params_from_numpy(tree, arch.model, device="cpu"),
        policy=policy, compute_dtype=torch.float32)
    assert tuple(lat_shape) == tuple(t_lat_shape)
    m = arch.model
    noise = rng.standard_normal((2, *lat_shape)).astype(np.float32)
    txt = (0.05 * rng.standard_normal((2, m.txt_tokens, m.txt_dim))).astype(
        np.float32)
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
    want, j_aux = j_fn(jnp.asarray(noise), jnp.asarray(txt), rngs)
    got, aux = fn(torch.from_numpy(noise), torch.from_numpy(txt))
    want = np.asarray(want)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 1e-3, rel
    for key in ("cache_hits", "cache_refreshes"):
        assert int(aux[key]) == int(j_aux[key]), key


def test_engine_buckets_on_reuse_every():
    built = []

    def factory(shape, steps, policy=None, reuse_every=None):
        built.append((policy, reuse_every))
        return lambda n, t, r: n

    eng = DiffusionEngine(factory, device="cpu", max_batch=2,
                          max_wait_s=0.01)
    eng.start()
    for rid, r in enumerate((None, 4, 4, 1)):
        eng.submit(GenRequest(request_id=rid, txt=np.zeros((1, 1), np.float32),
                              steps=2, latent_shape=(4, 4), reuse_every=r))
    for rid in range(4):
        eng.result(rid, timeout=60)
    eng.stop()
    assert len(built) == 3
    assert set(built) == {(None, None), (None, 1), (None, 4)}


def test_engine_refuses_cadence_it_cannot_honour():
    eng = DiffusionEngine(lambda shape, steps: (lambda n, t, r: n),
                          device="cpu")
    with pytest.raises(ValueError, match="reuse_every"):
        eng.submit(GenRequest(request_id=0, txt=np.zeros((1, 1), np.float32),
                              latent_shape=(2,), reuse_every=4))
    with pytest.raises(ValueError, match="default_reuse_every"):
        DiffusionEngine(lambda shape, steps: (lambda n, t, r: n),
                        device="cpu", default_reuse_every=4)
    eng2 = DiffusionEngine(lambda shape, steps, policy=None, reuse_every=None:
                           (lambda n, t, r: n), device="cpu")
    with pytest.raises(ValueError, match="positive"):
        eng2.submit(GenRequest(request_id=1, txt=np.zeros((1, 1), np.float32),
                               latent_shape=(2,), reuse_every=0))


def _dit_latents(*override):
    argv = ["--arch", "dit-xl2", "--smoke", "--device", "cpu",
            "--requests", "1", "--override", "model.num_layers=1"]
    for o in override:
        argv += ["--override", o]
    done = serve_lib.main(argv)
    assert len(done) == 1 and np.isfinite(done[0].latents).all()
    return done[0].latents


@pytest.mark.parametrize("setting", ["ripple.reuse_every=2",
                                     "ripple.drift_tol=0.1"])
def test_dit_serves_under_decision_cache_settings(setting):
    """The JAX launcher threads its decision cache for the vdit family
    only: a dit under these settings serves there, recomputing its
    decision on every step, so the port serves it too, with the latents
    of ``reuse_every=1`` bit for bit."""
    np.testing.assert_array_equal(_dit_latents(setting),
                                  _dit_latents("ripple.reuse_every=1"))


def test_main_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lib.main(["--smoke", "--requests", "1"])


class _Parsed(Exception):
    """Raised by the patched ``parse_args`` to stop ``main`` with its
    parser built."""


def _launcher_parser(main, monkeypatch):
    """The ``ArgumentParser`` a launcher's ``main`` builds, caught at its
    ``parse_args`` before anything is served."""
    import argparse

    seen = []

    def capture(self, *args, **kwargs):
        seen.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            main([])
    return seen[0]


def test_launcher_flag_defaults_equal_the_jax_launchers(monkeypatch):
    """Every flag both launchers take has the JAX launcher's default
    (``--requests`` 6: two requests a bucket of the mixed traffic)."""
    from repro.launch import serve as j_serve

    def defaults(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    port = defaults(_launcher_parser(serve_lib.main, monkeypatch))
    ref = defaults(_launcher_parser(j_serve.main, monkeypatch))
    shared = sorted(set(port) & set(ref))
    assert "requests" in shared and len(shared) > 20
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}


def test_registry_holds_the_lms_and_the_launcher_the_generating_families(
        monkeypatch):
    """``ALL_ARCHS`` is the JAX registry's, the four LMs included; the
    launcher's ``--arch`` choices stay exactly the generating families
    (the reference's launcher cannot serve an LM either)."""
    from repro.configs import ALL_ARCHS as J_ALL_ARCHS
    from repro_torch.configs import ALL_ARCHS, get_config

    assert sorted(ALL_ARCHS) == sorted(J_ALL_ARCHS)
    lms = [a for a in ALL_ARCHS if get_config(a).family == "lm"]
    assert sorted(lms) == sorted(["qwen3-32b", "gemma3-4b", "qwen2-moe-a2.7b",
                                  "phi3.5-moe-42b-a6.6b"])
    parser = _launcher_parser(serve_lib.main, monkeypatch)
    arch = next(a for a in parser._actions if a.dest == "arch")
    assert set(arch.choices) == {a for a in ALL_ARCHS if get_config(a).family
                                 in ("vdit", "dit", "mmdit", "unet")}


def test_bare_launcher_serves_two_requests_a_bucket():
    done = serve_lib.main(["--device", "cpu", "--smoke", "--override",
                           "model.num_layers=1"])
    assert [r.request_id for r in done] == list(range(6))
    shapes = [r.latents.shape for r in done]
    assert len(set(shapes)) == 2 and all(shapes.count(s) >= 2 for s in shapes)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    # ml_dtypes too: the card machine does not have it.
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, f"{path} imports {bad}"

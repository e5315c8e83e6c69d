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
                                        request_noise)

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
    done = serve_lib.main(["--device", "cpu", "--smoke", "--requests", "2",
                           "--override", "model.num_layers=1"])
    assert [r.request_id for r in done] == [0, 1]
    for r in done:
        assert r.latents.shape == (4, 8, 8, 4)
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


@pytest.mark.parametrize("args", [
    ["--override", "ripple.reuse_every=2"],
    ["--policy", "svg", "--override", "ripple.drift_tol=0.1"],
])
def test_main_refuses_decision_cache_settings(args):
    """The JAX launcher threads its cross-step decision cache for these
    settings; the port has none yet, so it refuses rather than serving a
    different trajectory."""
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        serve_lib.main(["--device", "cpu", "--smoke", "--requests", "1",
                        *args])


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
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"

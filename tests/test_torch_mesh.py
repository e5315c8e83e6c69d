"""The port's dispatch mesh (``launch/mesh.py``, ``distributed/spmd.py``,
batch/head sharding in ``core/dispatch.py``, DESIGN.md §10) against the
JAX package: the mesh grammar and its errors, sharded dispatch bit for
bit the unsharded one for every policy, plain and under the decision
cache, the plan's cache key and line as the reference's, the engine's
bucket key, and the launcher's ``--mesh`` on CPU shards
(``REPRO_TORCH_FORCE_DEVICE_COUNT``).  Inputs are made with numpy from a
seed."""

import dataclasses
import logging
import os
import threading
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config.base import RippleConfig as JRippleConfig  # noqa: E402
from repro.core import dispatch as j_dispatch  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro.serving import engine as j_engine  # noqa: E402
from repro_torch.config.base import RippleConfig  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.dispatch import (attention_dispatch,  # noqa: E402
                                       dispatch_mesh, resolve_plan)
from repro_torch.distributed import sharding, spmd  # noqa: E402
from repro_torch.distributed.spmd import P  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.mesh import (FORCE_DEVICE_COUNT_ENV, Mesh,  # noqa: E402
                                     make_host_mesh, parse_mesh_spec)
from repro_torch.serving import engine  # noqa: E402

torch.set_num_threads(2)

GRID = (4, 4, 4)
N = 64
STEP, TOTAL = 3, 6


def _cfg(**kw):
    return RippleConfig(enabled=True, theta_min=0.2, theta_max=0.5,
                        i_min=2, i_max=6, **kw)


def _qkv(seed, lead=(2, 4), n=N, d=16):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(lead + (n, d))
                                  .astype(np.float32)) for _ in range(3))


@pytest.fixture
def shards(monkeypatch):
    """Up to 8 CPU mesh shards for the test."""
    monkeypatch.setenv(FORCE_DEVICE_COUNT_ENV, "8")
    dispatch._PLAN_CACHE.clear()
    yield
    dispatch._PLAN_CACHE.clear()


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,shape", [
    ("8", {"data": 8, "model": 1}), ("4x2", {"data": 4, "model": 2}),
    ("2×2", {"data": 2, "model": 2}),
    ("1x1x2", {"data": 1, "model": 1, "seq": 2}),
    ("2x2x2", {"data": 2, "model": 2, "seq": 2})])
def test_parse_mesh_spec_grammar(shards, spec, shape):
    """The reference's grammar: D, DxM, DxMxS (a third component adds
    the seq axis), 'x' or '×'."""
    m = parse_mesh_spec(spec, device="cpu")
    assert m.shape == shape
    assert m.axis_names == tuple(shape)
    assert m.size == int(np.prod(list(shape.values())))
    assert all(d.type == "cpu" for d in m.devices)
    assert len(m.coords()) == m.size


@pytest.mark.parametrize("spec", ["1x2x3x4", "0x2", "2x-1"])
def test_parse_mesh_spec_refuses_what_the_reference_refuses(shards, spec):
    with pytest.raises(ValueError, match="mesh spec"):
        parse_mesh_spec(spec, device="cpu")
    with pytest.raises(ValueError, match="mesh spec"):
        j_mesh.parse_mesh_spec(spec)


def test_a_mesh_larger_than_the_devices_raises(monkeypatch):
    """Without the device-count variable the CPU is one device, so a
    2x2 mesh raises (the reference's message, naming the variable)."""
    monkeypatch.delenv(FORCE_DEVICE_COUNT_ENV, raising=False)
    with pytest.raises(ValueError, match=r"needs 4 devices but only 1 .*"
                                         + FORCE_DEVICE_COUNT_ENV):
        parse_mesh_spec("2x2", device="cpu")
    monkeypatch.setenv(FORCE_DEVICE_COUNT_ENV, "3")
    with pytest.raises(ValueError, match="needs 4 devices but only 3"):
        parse_mesh_spec("2x2", device="cpu")


def test_make_host_mesh_and_sharding_helpers(shards):
    m = make_host_mesh(model_axis=2, device="cpu")
    assert m.shape == {"data": 4, "model": 2}
    assert sharding.batch_axes(m) == ("data",)
    assert sharding.batch_axes(None) == ()
    assert sharding.axis_size(m, ("data", "model")) == 8
    assert sharding.axis_size(m, "model") == 2
    assert sharding.axis_size(m, None) == 1


def test_multi_host_init_is_not_ported():
    """Multi-process init was refused here until it was ported: now the
    mesh module has ``init_distributed`` (a no-op returning False once
    the group exists is held in ``tests/test_torch_distributed.py``), it
    refuses to guess a rendezvous, and the serving launcher takes the
    reference's ``--distributed`` flags with its defaults."""
    import argparse

    from repro_torch.launch import serve

    assert callable(mesh_lib.init_distributed)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    with mock.patch.dict(os.environ, env, clear=True):
        assert not mesh_lib.launched_by_torchrun()
        with pytest.raises(RuntimeError, match="torchrun"):
            mesh_lib.init_distributed(device="cpu")
    seen = {}

    def parse(self, argv=None):
        ns = orig(self, argv)
        seen.update(vars(ns))
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    with mock.patch.object(argparse.ArgumentParser, "parse_args", parse):
        with pytest.raises(SystemExit):
            serve.main(["--device", "cpu"])
    assert {k: seen[k] for k in ("distributed", "coordinator",
                                 "num_processes", "process_id")} == {
        "distributed": False, "coordinator": None, "num_processes": None,
        "process_id": None}


# ---------------------------------------------------------------------------
# The SPMD runtime
# ---------------------------------------------------------------------------


def test_collectives_match_their_jax_lax_meaning(shards):
    """ppermute, tiled all_gather, psum and pmax over one axis of a 2x2x2
    mesh, split and gathered by specs."""
    mesh = parse_mesh_spec("2x2x2", device="cpu")
    x = torch.arange(2 * 4 * 8 * 3, dtype=torch.float32).reshape(2, 4, 8, 3)
    spec = P("data", "model", "seq", None)

    def body(xs):
        return (spmd.ppermute(xs, "seq", [(0, 1), (1, 0)]),
                spmd.all_gather(xs, "seq", 2),
                spmd.psum(xs, "seq"), spmd.pmax(xs, "seq"),
                torch.full((1,), float(spmd.axis_index("seq"))))

    rot, gath, tot, top, idx = spmd.shard_map(
        body, mesh, (spec,),
        (spec, P("data", "model", None, None), P("data", "model", None, None),
         P("data", "model", None, None), P("seq")))(x)
    halves = x.reshape(2, 4, 2, 4, 3)
    assert torch.equal(rot, torch.cat([x[:, :, 4:], x[:, :, :4]], dim=2))
    assert torch.equal(gath, x)
    assert torch.equal(tot, halves[:, :, 0] + halves[:, :, 1])
    assert torch.equal(top, torch.maximum(halves[:, :, 0], halves[:, :, 1]))
    assert idx.tolist() == [0.0, 1.0]


def test_a_shard_exception_reaches_the_caller_without_a_hang(shards):
    """One shard raises while the others wait at a collective: the
    barrier is aborted, the original exception reaches the caller, and
    nothing is left waiting."""
    mesh = parse_mesh_spec("1x1x4", device="cpu")

    def body(xs):
        if spmd.axis_index("seq") == 2:
            raise KeyError("shard 2 failed")
        return spmd.psum(xs, "seq")

    result = {}

    def call():
        try:
            spmd.shard_map(body, mesh, (P(None, "seq"),), P(None, "seq"))(
                torch.ones((2, 8)))
        except BaseException as e:  # noqa: BLE001
            result["error"] = e

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "shard_map hung"
    assert isinstance(result.get("error"), KeyError)
    assert not [th for th in threading.enumerate()
                if th.name.startswith("shard") and th.is_alive()]


def test_a_cuda_mesh_never_runs_a_shard_on_the_cpu():
    """CPU operands under a CUDA mesh are refused before any shard runs."""
    cuda = torch.device("cuda", 0)
    mesh = Mesh(("data", "model"), (2, 1), (cuda, cuda))
    q = torch.zeros((2, 1, 8, 4))
    with pytest.raises(ValueError, match="cuda mesh got an operand on cpu"):
        spmd.shard_map(lambda x: x, mesh, (P("data"),), P("data"))(q)
    with pytest.raises(ValueError, match="cuda mesh got an operand on cpu"):
        attention_dispatch(q, q, q, grid=(2, 2, 2), cfg=_cfg(), step=STEP,
                           total_steps=TOTAL, backend="reference", mesh=mesh)


# ---------------------------------------------------------------------------
# Batch/head-sharded dispatch
# ---------------------------------------------------------------------------

POLICIES = {"ripple": None, "equal_mse": None, "svg": None, "dense": None,
            "static": None, "rainfusion": None, "collapse": "collapse"}


def _run(q, k, v, policy, mesh, cached, steps=3):
    """``steps`` dispatch calls (threading the decision cache when
    ``cached``) under ``mesh``; the outputs and the last state."""
    pol = "ripple" if policy == "collapse" else policy
    backend = POLICIES[policy]
    cfg = _cfg(reuse_every=2) if cached else _cfg()
    outs, state = [], None
    with dispatch_mesh(mesh):
        for s in range(steps):
            if cached and policy not in ("dense", "collapse"):
                out, state = attention_dispatch(
                    q, k, v, grid=GRID, cfg=cfg, step=STEP + s,
                    total_steps=TOTAL + steps, policy=pol, backend=backend,
                    cached_decision=state, return_decision=True)
            else:
                out = attention_dispatch(q, k, v, grid=GRID, cfg=cfg,
                                         step=STEP + s,
                                         total_steps=TOTAL + steps,
                                         policy=pol, backend=backend)
            outs.append(out)
    return outs, state


@pytest.mark.parametrize("cached", [False, True], ids=["plain", "cached"])
@pytest.mark.parametrize("spec", ["2", "1x2", "2x2"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_sharded_dispatch_is_bitwise_the_unsharded(shards, policy, spec,
                                                   cached):
    """Each shard decides on its own (batch, head) slice; the windows run
    along t/x/y only, so the outputs (and, under the cache, every step's
    output with hits and refreshes) equal the unsharded run bit for
    bit."""
    q, k, v = _qkv(21)
    want, want_state = _run(q, k, v, policy, None, cached)
    mesh = parse_mesh_spec(spec, device="cpu")
    got, state = _run(q, k, v, policy, mesh, cached)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if state is not None:
        assert torch.equal(state.hits, want_state.hits)
        assert torch.equal(state.refreshes, want_state.refreshes)
    plan = resolve_plan(q.shape, v.shape, _cfg(), on_cuda=False,
                        policy="ripple" if policy == "collapse" else policy,
                        backend=POLICIES[policy], mesh=mesh, grid=GRID)
    if policy == "dense":
        assert not plan.sharded
    else:
        d, m = (int(x) for x in (spec + "x1").split("x")[:2])
        assert (plan.batch_shards, plan.head_shards) == (d, m)
        assert f"shard=batch{d}xheads{m}" in plan.summary()


def test_indivisible_batch_replicates_the_batch_axis(shards):
    """A batch of 1 under a 2x2 mesh shards the heads only (the
    reference's replicated fallback), still bit for bit."""
    q, k, v = _qkv(22, lead=(1, 4))
    mesh = parse_mesh_spec("2x2", device="cpu")
    plan = resolve_plan(q.shape, v.shape, _cfg(), on_cuda=False, mesh=mesh)
    assert (plan.batch_axes, plan.head_axis) == ((), "model")
    assert "shard=batch1xheads2" in plan.summary()
    want = attention_dispatch(q, k, v, grid=GRID, cfg=_cfg(), step=STEP,
                              total_steps=TOTAL)
    got = attention_dispatch(q, k, v, grid=GRID, cfg=_cfg(), step=STEP,
                             total_steps=TOTAL, mesh=mesh)
    assert torch.equal(got, want)


def _fake_mesh(spec):
    """What the reference's plan resolution reads of a mesh (its axis
    names and shape), without devices: the test process's JAX has one."""
    dims = [int(x) for x in spec.split("x")]
    dims += [1] * (2 - len(dims))  # 'D' is (data=D, model=1)
    names = ("data", "model", "seq")[:len(dims)]
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names,
                                                                   dims)))


@pytest.mark.parametrize("spec", ["2", "2x2", "1x1x2", "2x2x2"])
@pytest.mark.parametrize("policy", ["ripple", "svg"])
def test_plan_key_and_line_match_the_reference(shards, policy, spec):
    """The plan cache key (the reference's, then the device kind) and the
    plan line (``shard=batchNxheadsM``, ``ring=seqS``) are the JAX
    package's."""
    shape = (2, 4, N, 16)
    cfg = _cfg()
    dispatch._PLAN_CACHE.clear()
    j_dispatch.clear_plan_cache()
    got = resolve_plan(shape, shape, cfg, on_cuda=False, policy=policy,
                       mesh=parse_mesh_spec(spec, device="cpu"), grid=GRID)
    want = j_dispatch.resolve_plan(shape, shape, JRippleConfig(
        **dataclasses.asdict(cfg)), policy=policy, mesh=_fake_mesh(spec),
        grid=GRID)
    assert got.summary() == want.summary()
    for f in ("batch_axes", "head_axis", "batch_shards", "head_shards",
              "seq_axis", "seq_shards", "sharded", "backend", "bucket"):
        assert getattr(got, f) == getattr(want, f), f
    (key,) = dispatch._PLAN_CACHE
    (j_key,) = j_dispatch._PLAN_CACHE
    assert key[:-1] == j_key and key[-1] is False


def test_engine_bucket_key_carries_the_seq_degree(shards):
    """Under a 1x1x2 mesh the bucket key's fifth entry is 2, as the JAX
    engine's ``_seq_shards``; 1 without a mesh."""
    assert engine._seq_shards() == 1 == j_engine._seq_shards()
    prev = j_dispatch.set_dispatch_mesh(_fake_mesh("1x1x2"))
    try:
        with dispatch_mesh(parse_mesh_spec("1x1x2", device="cpu")):
            assert engine._seq_shards() == 2 == j_engine._seq_shards()
            eng = engine.DiffusionEngine(lambda *a: None, device="cpu")
            req = engine.GenRequest(request_id=0, txt=np.zeros((8, 64),
                                                               np.float32),
                                    latent_shape=(4, 8, 8, 4), steps=3)
            assert eng._bucket_key(req)[4] == 2
    finally:
        j_dispatch.set_dispatch_mesh(prev)
    assert engine._seq_shards() == 1


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launcher_mesh_2x2_equals_the_unsharded_run(shards, caplog):
    """``--device cpu --smoke --mesh 2x2`` serves the same latents as the
    run without a mesh, bit for bit; each bucket logs its plan at every
    batch it runs, sharded over batch where the batch divides; the
    previous (absent) mesh is back afterwards."""
    from repro_torch.launch import serve

    argv = ["--device", "cpu", "--smoke", "--requests", "4"]
    want = {r.request_id: r.latents for r in serve.main(argv)}
    with caplog.at_level(logging.INFO, logger="repro_torch.launch.serve"):
        got = {r.request_id: r.latents for r in serve.main(argv + ["--mesh",
                                                                   "2x2"])}
    assert dispatch.active_dispatch_mesh() is None
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        assert np.array_equal(got[rid], want[rid])
    text = caplog.text
    assert "dispatch mesh: {'data': 2, 'model': 2}" in text
    assert "bucket gen_512 at batch 2: plan attention[ripple/reference " \
           "shard=batch2xheads2" in text
    assert "at batch 1: plan attention[ripple/reference shard=batch1xheads2" \
        in text


def test_launcher_mesh_larger_than_the_devices_raises(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.delenv(FORCE_DEVICE_COUNT_ENV, raising=False)
    with pytest.raises(ValueError, match="needs 4 devices but only 1"):
        serve.main(["--device", "cpu", "--smoke", "--mesh", "2x2"])
    assert dispatch.active_dispatch_mesh() is None


def test_attention_plan_of_a_cell_matches_the_reference(shards):
    """``workloads.attention_plan`` under a mesh: the reference's batch
    (the shape's times the guidance factor) and sharding."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch.workloads import attention_plan as j_plan
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.workloads import attention_plan

    arch, j_arch = get_smoke_config("vdit-paper"), j_smoke("vdit-paper")
    shape = arch.shape("gen_512")
    got = attention_plan(arch, shape, parse_mesh_spec("2x2", device="cpu"),
                         on_cuda=False)
    want = j_plan(j_arch, j_arch.shape("gen_512"), _fake_mesh("2x2"))
    assert got.summary() == want.summary()
    assert "shard=batch2xheads2" in got.summary()


@pytest.mark.parametrize("cached", [False, True], ids=["plain", "cached"])
def test_attn_nan_fault_fires_inside_a_sharded_call(shards, cached):
    """The ``attn_nan`` fault reaches a sharded call (the reference's
    injection site inside the sharded body, or after the gather on the
    plain path): every shard's output is NaN at the armed step, and the
    call counts one firing, not one a shard."""
    from repro_torch.serving import faults as fault_lib

    q, k, v = _qkv(23)
    mesh = parse_mesh_spec("2x2", device="cpu")
    fault_lib.clear_faults()
    fault_lib.install_faults(f"attn_nan:step={STEP}")
    try:
        with dispatch_mesh(mesh):
            out = attention_dispatch(q, k, v, grid=GRID, cfg=_cfg(),
                                     step=STEP, total_steps=TOTAL,
                                     return_decision=cached)
        out = out[0] if cached else out
        assert torch.isnan(out).all()
        assert fault_lib.active_faults().counters() == {"fault_attn_nan": 1}
    finally:
        fault_lib.clear_faults()

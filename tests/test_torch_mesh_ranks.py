"""The port's dispatch mesh over several processes, on the CPU over gloo:
``launch.mesh.parse_mesh_spec`` once a process group exists, the
collectives of ``distributed.spmd`` across ranks, sharded dispatch (the
batch/head shards and the seq ring), expert parallelism and the LM's
serving steps, each at 2 and 4 ranks against one process's threaded mesh
of the same shape (``REPRO_TORCH_FORCE_DEVICE_COUNT``), bit for bit on
every rank; the plan lines against the reference's; the mesh's errors
with a group; and a shard's exception on one rank raising on every rank.

Every process runs the same jobs (``WORKER``) and writes what it got;
the one-process runs are processes too, with the same thread settings,
so that the comparison is of the mesh alone.  Inputs are made with numpy
from a seed."""

import json
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import (LIMIT_S, _env, _free_port,  # noqa: E402
                                    _join, _start)

from repro.config.base import RippleConfig as JRippleConfig  # noqa: E402
from repro.core import dispatch as j_dispatch  # noqa: E402

# Each process: its rank's share of every job, written to OUT/<job>-<rank>.npz
# (and the plan lines and error messages to OUT/meta-<rank>.json).  With
# a world size of 0 it is the one-process mesh.  The device-count
# variable is set a job at a time: the mesh reads it when it is built.
WORKER = textwrap.dedent(r"""
    import dataclasses, json, os, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.config.base import MoEConfig, RippleConfig
    from repro_torch.core import dispatch
    from repro_torch.core.dispatch import attention_dispatch, dispatch_mesh
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import ShardCtx, decode_act_rules
    from repro_torch.distributed.spmd import P
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.mesh import (FORCE_DEVICE_COUNT_ENV,
                                         init_distributed, parse_mesh_spec)
    from repro_torch.models import moe

    torch.set_num_threads(1)
    out, world, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    rank = int(os.environ.get("RANK", 0))
    if world:
        init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                         timeout_s=60)
    meta = {"plans": {}, "errors": {}}

    def mesh(spec, ways):
        # ``ways`` coordinates over the world: each rank gets its share.
        os.environ[FORCE_DEVICE_COUNT_ENV] = str(ways // max(world, 1))
        return parse_mesh_spec(spec, device="cpu")

    def save(job, **arrays):
        np.savez(f"{out}/{job}-{rank}.npz",
                 **{k: v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v for k, v in arrays.items()})

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8, 3)).astype(np.float32))
    m = mesh("2x2x2", 8)
    if world:
        meta["mesh"] = {"ranks": list(m.ranks), "groups": len(m.groups),
                        "visible": len(mesh_lib.visible_devices("cpu")),
                        "again": init_distributed(device="cpu")}
    spec = P("data", "model", "seq", None)

    def body(xs):
        return (spmd.ppermute(xs, "seq", [(0, 1), (1, 0)]),
                spmd.ppermute(xs, "data", [(0, 1)]),
                spmd.ppermute(xs, "model", [(1, 0)]),
                spmd.all_gather(xs, "data", 0),
                spmd.psum(xs, "model"), spmd.psum(xs, ("data", "seq")),
                spmd.pmean(xs, ("data", "model", "seq")),
                spmd.pmax(xs, "data"),
                torch.full((1,), float(spmd.axis_index("seq"))))

    red = P(None, "model", "seq", None)
    names = ("rot_seq", "send_data", "send_model", "gather", "psum_model",
             "psum_data_seq", "pmean", "pmax", "index")
    res = spmd.shard_map(body, m, (spec,), (
        spec, spec, spec, red, P("data", None, "seq", None),
        P(None, "model", None, None), P(), red, P("seq")))(x)
    save("collectives", **dict(zip(names, res)))

    def cfg(**kw):
        return RippleConfig(enabled=True, theta_min=0.2, theta_max=0.5,
                            i_min=2, i_max=6, **kw)

    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 64, 16))
                                .astype(np.float32)) for _ in range(3))
    for spec_s, ways in (("2x2", 4), ("1x1x2", 2)):
        if ways < world:
            continue  # fewer coordinates than ranks
        for pol in ("ripple", "svg"):
            backend = "reference" if pol == "ripple" else None
            dm = mesh(spec_s, ways)
            dispatch._PLAN_CACHE.clear()
            plan = dispatch.resolve_plan(q.shape, v.shape, cfg(),
                                         on_cuda=False, policy=pol,
                                         backend=backend, mesh=dm,
                                         grid=(4, 4, 4))
            meta["plans"][f"{pol}-{spec_s}"] = plan.summary()
            outs, state = {}, None
            with dispatch_mesh(dm):
                for s in range(3):
                    outs[f"plain{s}"] = attention_dispatch(
                        q, k, v, grid=(4, 4, 4), cfg=cfg(), step=3 + s,
                        total_steps=9, policy=pol, backend=backend)
                    outs[f"cached{s}"], state = attention_dispatch(
                        q, k, v, grid=(4, 4, 4), cfg=cfg(reuse_every=2),
                        step=3 + s, total_steps=9, policy=pol,
                        backend=backend, cached_decision=state,
                        return_decision=True)
            save(f"dispatch-{pol}-{spec_s}", hits=state.hits,
                 refreshes=state.refreshes, **outs)

    # An armed attn_nan fault inside the cached sharded call: counted by
    # the shard at coordinate 0 (spmd.first_shard), so by rank 0 alone.
    from repro_torch.serving import faults as fault_lib

    fault_lib.install_faults("attn_nan:step=3")
    with dispatch_mesh(mesh("2x2", 4)):
        o, _ = attention_dispatch(q, k, v, grid=(4, 4, 4), cfg=cfg(),
                                  step=3, total_steps=9,
                                  return_decision=True)
    meta["fault"] = {"nan": bool(torch.isnan(o).all()),
                     "counters": fault_lib.active_faults().counters()}
    fault_lib.clear_faults()

    # EP: the reference test's MoE on (2, 64, 16) tokens, f32, at a
    # capacity that drops slots and one that does not; every (token
    # shard, model shard)'s kept-slot mask recorded where it is made.
    xe = torch.from_numpy(rng.standard_normal((2, 64, 16)).astype(np.float32))
    keeps = {}
    orig = moe.dispatch_slots

    def recording(idx, e_lo, E_loc, C):
        got = orig(idx, e_lo, E_loc, C)
        if getattr(spmd._CTX, "shard", None) is not None:
            keeps[f"keep/{spmd.axis_index('data')}/"
                  f"{spmd.axis_index('model')}"] = got[0].clone()
        return got

    moe.dispatch_slots = recording
    for name, cf in (("no-drop", 16.0), ("drops", 0.5)):
        for spec_s in ("2x4", "1x4"):
            ways = 8 if spec_s == "2x4" else 4
            em = mesh(spec_s, ways)
            ecfg = MoEConfig(num_experts=8, top_k=2, expert_ffw_dim=32,
                             capacity_factor=cf)
            torch.manual_seed(0)
            p = moe.MoE(16, ecfg)
            with torch.no_grad():
                for leaf in ("router", "wi_gate", "wi_up", "wo"):
                    getattr(p, leaf).normal_(0.0, 0.2)
                keeps.clear()
                y, aux = moe.moe_ffn(p, xe, ecfg, impl="ep", ctx=ShardCtx(
                    em, decode_act_rules(em)))
            save(f"ep-{name}-{spec_s}", out=y, aux=aux, **keeps)
    moe.dispatch_slots = orig

    # The smoke qwen2-moe's serving steps (bf16) under a 1x4 mesh: its
    # MoE layers take EP with the experts split over the ranks.
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.workloads import lm_serve_steps
    from repro_torch.models.params import init_model

    arch = get_smoke_config("qwen2-moe-a2.7b")
    model = init_model(arch.model, seed=0, device="cpu", zero_init=False)
    shape = dataclasses.replace(arch.shape("decode_32k"), seq_len=32)
    tokens = torch.from_numpy(rng.integers(0, arch.model.vocab_size,
                                           (2, 12)))
    prefill, decode = lm_serve_steps(arch, shape, model,
                                     mesh=mesh("1x4", 4))
    logits, cache = prefill(tokens)
    nxt, _ = decode(logits.argmax(-1), cache, 12)
    save("lm-qwen2-moe", prefill=logits.float(), decode=nxt.float())

    if world:
        # The mesh's errors with a group, naming both counts.
        for spec_s, per in (("4x4", 2), ("3", 2)):
            os.environ[FORCE_DEVICE_COUNT_ENV] = str(per)
            try:
                parse_mesh_spec(spec_s, device="cpu")
            except ValueError as e:
                meta["errors"][spec_s] = str(e)
    with open(f"{out}/meta-{rank}.json", "w") as f:
        json.dump(meta, f)
    if world:
        dist.barrier()
        dist.destroy_process_group()
""")

# (policy, mesh, ranks): 1x1x2 has fewer coordinates than 4 ranks.
DISPATCH = [(pol, spec, n) for spec, ranks in (("2x2", (2, 4)),
                                               ("1x1x2", (2,)))
            for n in ranks for pol in ("ripple", "svg")]
EP = [(name, spec) for name in ("no-drop", "drops") for spec in ("2x4", "1x4")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker at one process, 2 ranks and 4 ranks, all at once; the
    output directory of each."""
    dirs = {n: tmp_path_factory.mktemp(f"ranks{n}") for n in (0, 2, 4)}
    groups = []
    for n, d in dirs.items():
        port = _free_port()
        groups.append(_start(n, lambda r, d=d, n=n, port=port: [
            "-c", WORKER, str(d), str(n), str(port)]))
    for res in _join(*groups):
        for rc, text in res:
            assert rc == 0, text[-4000:]
    return dirs


def _load(runs, n, job, rank=0):
    return np.load(runs[n] / f"{job}-{rank}.npz")


def _meta(runs, n, rank=0):
    return json.loads((runs[n] / f"meta-{rank}.json").read_text())


def _equal(a, b, keys=None):
    keys = sorted(a.files) if keys is None else keys
    assert sorted(a.files) == sorted(b.files)
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("ranks", [2, 4])
def test_collectives_match_one_process(runs, ranks):
    """ppermute (over an axis within a rank and across ranks, a partial
    permutation), tiled all_gather, psum over one and two axes, pmean
    over three and pmax on a 2x2x2 mesh at 2 ranks x 4 shards and 4 x 2:
    every rank's outputs bit-equal to one process's 8 threads."""
    one = _load(runs, 0, "collectives")
    for r in range(ranks):
        _equal(one, _load(runs, ranks, "collectives", r))


def test_the_mesh_lays_out_every_rank_rank_major(runs):
    """2x2x2 over 2 ranks holds 4 coordinates a rank, over 4 ranks 2,
    rank-major, with one process group an axis group that spans ranks
    (and one of every rank); the visible devices are every rank's, and
    init_distributed is a no-op once the group exists."""
    two, four = _meta(runs, 2)["mesh"], _meta(runs, 4, 3)["mesh"]
    assert two["ranks"] == [0] * 4 + [1] * 4
    assert four["ranks"] == [0, 0, 1, 1, 2, 2, 3, 3]
    # 2 ranks: the 4 data groups span; 4 ranks: 4 data + 4 model groups.
    assert (two["groups"], four["groups"]) == (5, 9)
    assert (two["visible"], four["visible"]) == (8, 8)
    assert two["again"] is False and four["again"] is False


@pytest.mark.parametrize("ranks", [2, 4])
def test_mesh_errors_with_a_group_name_both_counts(runs, ranks):
    """A mesh larger than every rank's devices raises naming both counts;
    one that does not split evenly over the ranks raises too (the case
    without a group is ``tests/test_torch_mesh.py``'s)."""
    errors = _meta(runs, ranks)["errors"]
    assert (f"needs 16 devices but only {2 * ranks} are visible over "
            f"{ranks} ranks ({[2] * ranks} a rank)") in errors["4x4"]
    assert f"does not split evenly over {ranks} ranks" in errors["3"]


def _fake_mesh(spec):
    dims = [int(x) for x in spec.split("x")]
    dims += [1] * (2 - len(dims))
    names = ("data", "model", "seq")[:len(dims)]
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, dims)))


@pytest.mark.parametrize("policy,spec,ranks", DISPATCH)
def test_dispatch_over_ranks_matches_one_process(runs, policy, spec,
                                                 ranks):
    """``attention_dispatch`` under ripple (reference backend) and svg
    (the sparse backend; the true ring at 1x1x2) at ``--mesh 2x2`` over
    2 and 4 ranks and ``1x1x2`` over 2: three plain steps and three under
    the decision cache bit-equal, on every rank, to the one-process mesh,
    with the hit and refresh counters; the plan line is the reference's
    for that mesh shape."""
    job = f"dispatch-{policy}-{spec}"
    one = _load(runs, 0, job)
    for r in range(ranks):
        _equal(one, _load(runs, ranks, job, r))
    cfg = JRippleConfig(enabled=True, theta_min=0.2, theta_max=0.5,
                        i_min=2, i_max=6)
    j_dispatch.clear_plan_cache()
    want = j_dispatch.resolve_plan(
        (2, 4, 64, 16), (2, 4, 64, 16), cfg, policy=policy,
        backend="reference" if policy == "ripple" else None,
        mesh=_fake_mesh(spec), grid=(4, 4, 4))
    for n in (0, ranks):
        assert _meta(runs, n)["plans"][f"{policy}-{spec}"] == want.summary()
    assert ("ring=seq2" in want.summary()) == (spec == "1x1x2")


@pytest.mark.parametrize("ranks", [2, 4])
def test_a_fault_inside_a_sharded_call_counts_on_rank_0(runs, ranks):
    """``first_shard()`` is the global coordinate 0, which rank 0 holds:
    an ``attn_nan`` fault inside the cached sharded call turns every
    rank's output to NaN and counts one firing on rank 0, as the one
    process does, and none on the other ranks."""
    assert _meta(runs, 0)["fault"] == {"nan": True, "counters": {
        "fault_attn_nan": 1}}
    for r in range(ranks):
        got = _meta(runs, ranks, r)["fault"]
        assert got["nan"]
        assert got["counters"] == ({"fault_attn_nan": 1} if r == 0 else {})


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("case,spec", EP)
def test_ep_over_ranks_matches_one_process(runs, ranks, case, spec):
    """EP (``moe_ffn(impl="ep")``, f32) on a 2x4 mesh (experts over a
    ``model`` axis within a rank at 2 ranks, across ranks at 4) and a
    1x4 one (across ranks at both): output, aux and every (token shard,
    model shard)'s kept-slot mask, gathered from the ranks that made
    them, bit-equal to one process's EP mesh; with drops at capacity
    0.5."""
    job = f"ep-{case}-{spec}"
    one = _load(runs, 0, job)
    got = [_load(runs, ranks, job, r) for r in range(ranks)]
    for g in got:
        for k in ("out", "aux"):
            np.testing.assert_array_equal(g[k], one[k])
    keeps = {}
    for g in got:
        keeps.update({k: g[k] for k in g.files if k.startswith("keep/")})
    assert sorted(keeps) == sorted(k for k in one.files
                                   if k.startswith("keep/"))
    for k, v in keeps.items():
        np.testing.assert_array_equal(v, one[k], err_msg=k)
    # Each token shard's slots, counted once over its model shards.
    routed = 128 * 2
    kept = sum(int(one[k].sum()) for k in keeps)
    assert (kept == routed) == (case == "no-drop"), (kept, routed)


@pytest.mark.parametrize("ranks", [2, 4])
def test_lm_serve_steps_over_ranks_match_one_process(runs, ranks):
    """``lm_serve_steps`` of the smoke qwen2-moe under a 1x4 mesh (the
    reference's ``ShardCtx(mesh, decode_act_rules(mesh))``; its experts
    over a ``model`` axis across the ranks): the prefill's logits and a
    decode step's bit-equal, on every rank, to one process's."""
    one = _load(runs, 0, "lm-qwen2-moe")
    for r in range(ranks):
        _equal(one, _load(runs, ranks, "lm-qwen2-moe", r))


FAIL = textwrap.dedent(r"""
    import os, sys
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import spmd
    from repro_torch.distributed.spmd import P
    from repro_torch.launch.mesh import init_distributed, parse_mesh_spec

    port, collective = sys.argv[1], sys.argv[2] == "1"
    rank = int(os.environ["RANK"])
    init_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu",
                     timeout_s=20)
    mesh = parse_mesh_spec("2x2", device="cpu")

    def body(xs):
        if rank == 1 and spmd.axis_index("model") == 1:
            raise KeyError("shard (1, 1) failed")
        return spmd.psum(xs, "data") if collective else xs * 2

    try:
        spmd.shard_map(body, mesh, (P("data", "model"),),
                       P(None, "model") if collective else
                       P("data", "model"))(torch.ones((4, 4)))
    except BaseException as e:
        print("RAISED", type(e).__name__, e, flush=True)
        os._exit(3)
    print("NO ERROR", flush=True)
""")


@pytest.mark.parametrize("collective", [False, True],
                         ids=["no-collective", "psum-across-ranks"])
def test_a_shard_exception_on_one_rank_raises_on_every_rank(collective):
    """One shard of rank 1 raises: rank 1 raises it, and rank 0 raises
    too within the limit, from the status all-gather after the call (a
    body without collectives) or when its exchange with the failed shard
    runs out of the group's timeout (20 s here)."""
    port = _free_port()
    res = _join(_start(2, lambda r: ["-c", FAIL, str(port),
                                     "1" if collective else "0"],
                       env_of=lambda r: dict(
                           _env(r, 2, port),
                           REPRO_TORCH_FORCE_DEVICE_COUNT="2")),
                limit=LIMIT_S)[0]
    (rc0, t0), (rc1, t1) = res
    assert rc1 == 3 and "RAISED KeyError" in t1, t1[-3000:]
    assert rc0 == 3 and "RAISED" in t0, t0[-3000:]
    if not collective:
        assert "a shard on rank(s) [1] failed" in t0, t0[-3000:]

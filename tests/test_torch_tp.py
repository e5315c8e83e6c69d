"""The LM train step on a (data x model) rank mesh, on the CPU over gloo:
tensor parallelism (heads, MLP and vocab on ``model``), EP for the MoE
and sequence parallelism (``distributed.tensor_parallel``), with FSDP
over ``data`` (``distributed.fsdp``).

* N ranks against one process: at (data, model) = (1, 2), (2, 2) and
  (1, 4), 3 AdamW steps of the smoke gemma3-4b, qwen3-32b (whose kv
  piece at model 4 is half a head) and qwen2-moe-a2.7b, with and without
  ``train.seq_parallel``, in float32: the per-step losses and the final
  params within 1e-5 relative, the first moments within 1e-4.  The MoE
  on two data ranks takes the reference's per-shard aux loss (the router
  statistics of each data rank's tokens, averaged), where one process
  takes the whole batch's; there its nll and params are held to one
  process, and its aux and moments to the reference's (below).
* Against the reference: a subprocess runs the JAX package's
  ``build_workload(arch, "train_4k", mesh)`` jitted on a (2, 2) mesh of
  4 virtual CPU devices, with the port's initial params and first batch
  passed across through numpy and the reference's ``lm_loss`` taken in
  float32 (its workload passes no compute dtype: bfloat16); the port's
  4 gloo ranks at (2, 2) take the same batch.  After one step the loss
  and the params within 1e-5, the first moments within 1e-4.
* The pieces: a piece that ends mid-head, and the sequence pieces."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import _env, _free_port, _join  # noqa: E402

LIMIT_S = 120
ARCHS = ("gemma3-4b", "qwen3-32b", "qwen2-moe-a2.7b")
MESHES = ((1, 2), (2, 2), (1, 4))
SEQ, BATCH, STEPS = 32, 4, 3

# Each process runs its JSON list of jobs: a smoke LM at SEQ x BATCH
# tokens in float32, on a rank mesh of model axis ``model`` (none without
# the env:// variables), ``steps`` AdamW steps from ``start`` (restoring
# the checkpoint in ``ckpt`` when it holds one).  Rank 0 writes the
# per-step losses, nll and aux, the state tree after the first step
# (``out1``) and at the end (``out``), and the restored tree.
WORKER = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import DataSpec
    from repro_torch.launch import workloads
    from repro_torch.launch.mesh import init_distributed, make_rank_mesh
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.params import init_model
    from repro_torch.training import train_loop

    torch.set_num_threads(1)
    ranked = "RANK" in os.environ
    if ranked:
        init_distributed(device="cpu")
    rank0 = not ranked or dist.get_rank() == 0

    def flat(t, pre=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(flat(v, f"{pre}/{k}" if pre else k))
            return out
        if isinstance(t, list):
            out = {}
            for i, v in enumerate(t):
                out.update(flat(v, f"{pre}/{i}"))
            return out
        return {pre: np.asarray(t.detach().cpu() if
                                isinstance(t, torch.Tensor) else t)}

    for job in json.loads(sys.argv[1]):
        arch = get_smoke_config(job["arch"])
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, **job.get("over", {})))
        shape = dataclasses.replace(arch.shape("train_4k"),
                                    seq_len=job["seq"],
                                    global_batch=job["batch"])
        arch = dataclasses.replace(arch, shapes=(shape,),
                                   train=dataclasses.replace(
            arch.train, compute_dtype="float32", seq_parallel=job["sp"],
            grad_compression=job.get("int8", False)))
        mesh = (make_rank_mesh(model_axis=job["model"], device="cpu")
                if ranked else None)
        model = init_model(arch.model, seed=0, device="cpu",
                           dtype=torch.float32)
        step = workloads.train_step(arch, shape, model, mesh=mesh)
        state = train_loop.train_state_init(model, arch.train, mesh=mesh)
        start, ckpt = 0, None
        if job.get("ckpt"):
            ckpt = Checkpointer(job["ckpt"], keep=5, async_save=False)
            found, arrays, _ = ckpt.restore_latest()
            if found is not None:
                state = train_loop.load_state_tree(state, arrays)
                start = found
                tree = train_loop.state_tree(state)
                if rank0:
                    np.savez(job["restored"], **flat(tree))
        fn = make_batch_fn(arch, shape, "cpu")
        hist = {"loss": [], "nll": [], "aux": []}
        for i in range(start, job["steps"]):
            state, m = step(state, fn(DataSpec(seed=0), i), 0)
            for k in hist:
                hist[k].append(float(m[k]))
            if i == start and job.get("out1"):
                tree = train_loop.state_tree(state)
                if rank0:
                    np.savez(job["out1"], **flat(tree))
        tree = train_loop.state_tree(state)
        if ckpt is not None and rank0:
            ckpt.save(job["steps"], tree)
            ckpt.wait()
        if rank0 and job.get("out"):
            np.savez(job["out"], **flat(tree),
                     **{f"hist/{k}": np.array(v) for k, v in hist.items()})
    if ranked:
        dist.barrier()
        dist.destroy_process_group()
""")

# The reference's train step of each job on a (2, 2) mesh of 4 virtual
# devices, from the port's initial params and first batch; writes the
# state tree after one step and the metrics.
REFERENCE = textwrap.dedent("""
    import dataclasses, functools, json, sys
    import numpy as np, jax, jax.numpy as jnp, torch
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch import workloads as jw
    from repro.models import transformer_lm as jlm
    from repro.training import train_loop as jloop
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import DataSpec
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.params import init_model, jax_tree

    jlm.lm_loss = functools.partial(jlm.lm_loss, compute_dtype=jnp.float32)
    # GSPMD's sharding constraints need the mesh's axes to be Auto.
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)

    def cut(arch, seq, batch, sp):
        shape = dataclasses.replace(arch.shape("train_4k"), seq_len=seq,
                                    global_batch=batch)
        return dataclasses.replace(arch, shapes=(shape,),
                                   train=dataclasses.replace(
            arch.train, compute_dtype="float32", seq_parallel=sp))

    def flat(t, pre=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(flat(v, f"{pre}/{k}" if pre else k))
            return out
        if isinstance(t, (list, tuple)):
            out = {}
            for i, v in enumerate(t):
                out.update(flat(v, f"{pre}/{i}"))
            return out
        return {pre: np.asarray(t)}

    for job in json.loads(sys.argv[1]):
        arch = cut(get_smoke_config(job["arch"]), job["seq"], job["batch"],
                   job["sp"])
        jarch = cut(j_smoke(job["arch"]), job["seq"], job["batch"], job["sp"])
        model = init_model(arch.model, seed=0, device="cpu",
                           dtype=torch.float32)
        params = jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.detach().numpy()), jax_tree(model))
        batch = make_batch_fn(arch, arch.shape("train_4k"), "cpu")(
            DataSpec(seed=0), 0)
        batch = {k: jnp.asarray(v.numpy().astype(np.int32))
                 for k, v in batch.items()}
        wl = jw.build_workload(jarch, "train_4k", mesh)
        state = jloop.train_state_init(params, jarch.train)
        fn = jax.jit(wl.fn, in_shardings=wl.in_shardings,
                     out_shardings=wl.out_shardings)
        state, m = fn(state, batch, jax.random.PRNGKey(0))
        tree = {"params": state.params, "opt": {"mu": state.opt.mu}}
        np.savez(job["out"], **flat(tree),
                 **{f"hist/{k}": np.array([float(m[k])])
                    for k in ("loss", "nll", "aux")})
""")


def _start(ranks, script, jobs, env_extra=None):
    port = _free_port()
    procs = []
    for r in range(max(ranks, 1)):
        env = _env(r if ranks else None, ranks, port)
        env.update(env_extra or {})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, json.dumps(jobs)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
    return procs


def _check(results):
    for res in results:
        for rc, text in res:
            assert rc == 0, text[-4000:]


def _job(d, arch, sp, mesh, **extra):
    tag = "one" if mesh is None else "x".join(map(str, mesh))
    return dict(arch=arch, sp=sp, seq=SEQ, batch=BATCH, steps=STEPS,
                model=1 if mesh is None else mesh[1],
                out=str(d / f"{arch}-{sp}-{tag}.npz"), **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every (arch, seq_parallel) at one process and on each mesh of
    MESHES, and the reference's step at (2, 2), all started at once."""
    d = tmp_path_factory.mktemp("tp")
    groups = {}
    ref = []
    for arch in ARCHS:
        for sp in (False, True):
            groups.setdefault((0, arch), []).append(_job(d, arch, sp, None))
            for mesh in MESHES:
                extra = {}
                if mesh == (2, 2):
                    extra["out1"] = str(d / f"{arch}-{sp}-2x2-step1.npz")
                groups.setdefault((mesh[0] * mesh[1], mesh[1]), []).append(
                    _job(d, arch, sp, mesh, **extra))
            if not sp or arch == "qwen3-32b":
                ref.append(dict(arch=arch, sp=sp, seq=SEQ, batch=BATCH,
                                out=str(d / f"{arch}-{sp}-ref.npz")))
    for tag, over, sp in ODD:
        for mesh in (None, (1, 4)):
            job = _job(d, "qwen3-32b", sp, mesh, over=over)
            job["out"] = job["out"].replace(".npz", f"-{tag}.npz")
            groups.setdefault((4, 4) if mesh else (0, tag), []).append(job)
    for mesh in (None, (2, 2)):  # int8 error feedback on the data axis
        job = _job(d, "qwen3-32b", False, mesh, int8=True)
        job["out"] = job["out"].replace(".npz", "-int8.npz")
        groups.setdefault((4, 2) if mesh else (0, "int8"), []).append(job)
    started = [_start(ranks, WORKER, jobs) for (ranks, _), jobs in
               groups.items()]
    started.append(_start(0, REFERENCE, ref, {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}))
    _check(_join(*started, limit=LIMIT_S))
    return d


def _rel(a, b, prefix):
    keys = sorted(k for k in b.files if k.startswith(prefix + "/"))
    assert keys and all(k in a.files for k in keys), prefix
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2))
              for k in keys)
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in keys)
    return (num / den) ** 0.5


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


CASES = [(a, sp, m) for a in ARCHS for sp in (False, True) for m in MESHES]
# Shapes the model group does not divide, at (1, 4): a vocab of 254 (the
# embedding and head whole on every rank; under sequence parallelism the
# cross entropy of each rank's tokens summed over the group), and 2 query
# heads (every rank attends with both and takes its rows of wo).
ODD = (("vocab254", {"vocab_size": 254}, True),
       ("heads2", {"num_heads": 2, "num_kv_heads": 1}, False))


@pytest.mark.parametrize("arch,sp,mesh", CASES, ids=[
    f"{a}-{'sp' if sp else 'tp'}-{m[0]}x{m[1]}" for a, sp, m in CASES])
def test_ranks_match_one_process(runs, arch, sp, mesh):
    one = np.load(runs / f"{arch}-{sp}-one.npz")
    got = np.load(runs / f"{arch}-{sp}-{mesh[0]}x{mesh[1]}.npz")
    assert int(got["opt/step"]) == int(one["opt/step"]) == STEPS
    per_shard_aux = arch == "qwen2-moe-a2.7b" and mesh[0] > 1
    key = "hist/nll" if per_shard_aux else "hist/loss"
    assert _max_rel(got[key], one[key]) <= 1e-5
    assert _rel(got, one, "params") <= 1e-5
    if per_shard_aux:
        # The per-shard mean differs from the whole batch's, and so do the
        # router's gradients (the moments): both are held to the
        # reference's by test_two_by_two_matches_the_reference.
        assert not np.array_equal(got["hist/aux"], one["hist/aux"])
    else:
        assert _rel(got, one, "opt/mu") <= 1e-4


def test_int8_compression_on_the_data_axis(runs):
    """``train.grad_compression`` at (2, 2): the int8 round trip of each
    gradient piece with the whole tensor's scale (the maximum over every
    rank), against one process's: params within 1e-5, the residuals'
    tree within 1e-2 (a rounding flip moves one element by a step)."""
    one = np.load(runs / "qwen3-32b-False-one-int8.npz")
    got = np.load(runs / "qwen3-32b-False-2x2-int8.npz")
    assert any(k.startswith("compression/error/") for k in got.files)
    assert _max_rel(got["hist/loss"], one["hist/loss"]) <= 1e-5
    assert _rel(got, one, "params") <= 1e-5
    assert _rel(got, one, "compression/error") <= 1e-2


@pytest.mark.parametrize("tag", [t for t, _, _ in ODD])
def test_undivided_vocab_and_heads_match_one_process(runs, tag):
    sp = dict((t, s) for t, _, s in ODD)[tag]
    one = np.load(runs / f"qwen3-32b-{sp}-one-{tag}.npz")
    got = np.load(runs / f"qwen3-32b-{sp}-1x4-{tag}.npz")
    assert _max_rel(got["hist/loss"], one["hist/loss"]) <= 1e-5
    assert _rel(got, one, "params") <= 1e-5
    assert _rel(got, one, "opt/mu") <= 1e-4


REF_CASES = [(a, False) for a in ARCHS] + [("qwen3-32b", True)]


@pytest.mark.parametrize("arch,sp", REF_CASES, ids=[
    f"{a}-{'sp' if sp else 'tp'}" for a, sp in REF_CASES])
def test_two_by_two_matches_the_reference(runs, arch, sp):
    want = np.load(runs / f"{arch}-{sp}-ref.npz")
    got = np.load(runs / f"{arch}-{sp}-2x2-step1.npz")
    run = np.load(runs / f"{arch}-{sp}-2x2.npz")
    for k in ("loss", "nll", "aux"):
        w = float(want[f"hist/{k}"][0])
        assert abs(run[f"hist/{k}"][0] - w) <= 1e-5 * max(abs(w), 1e-3), k
    assert _rel(got, want, "params") <= 1e-5
    assert _rel(got, want, "opt/mu") <= 1e-4


def _mesh(data, model):
    from repro_torch.launch.dryrun import _Rank0
    from repro_torch.launch.mesh import RankMesh

    return RankMesh(("data", "model"), (data, model), torch.device("cpu"),
                    _Rank0(2))


@pytest.mark.parametrize("name,model,piece,head_dim", [
    ("qwen3-32b", 4, 4, 8), ("gemma3-4b", 4, 8, 16)])
def test_kv_piece_ends_mid_head(name, model, piece, head_dim):
    """The rule tables split the flattened kv dim where it divides, even
    mid-head (as qwen3-32b's 8 x 128 at model 16 gives 64 columns): the
    smoke configs at model 4 hold half a head a rank."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.elastic import local_piece
    from repro_torch.distributed.sharding import param_rules, spec_from_axes

    cfg = get_smoke_config(name).model
    assert cfg.resolved_head_dim == head_dim
    mesh = _mesh(1, model)
    kv = cfg.num_kv_heads * head_dim
    spec = spec_from_axes(("embed", "kv"), param_rules(mesh),
                          (cfg.d_model, kv), mesh)
    w = torch.arange(cfg.d_model * kv, dtype=torch.float32).reshape(
        cfg.d_model, kv)
    got = local_piece(w, spec, mesh, {"data": 0, "model": 1})
    assert tuple(got.shape) == (cfg.d_model, piece)
    assert torch.equal(got, w[:, piece:2 * piece])
    assert piece < head_dim


def test_sequence_pieces_and_the_region_primitives():
    """One rank's view of the primitives: ``span`` splits as the pieces
    do (unevenly where the group does not divide), and a weight's
    ``take`` uses the piece as it is when it holds the wanted items."""
    from repro_torch.distributed.tensor_parallel import TensorParallel, span

    assert [span(10, 4, i) for i in range(4)] == [(0, 2), (2, 5), (5, 7),
                                                  (7, 10)]
    tp = TensorParallel(None, 4, 1, seq_parallel=True)
    w = torch.randn(6, 8)
    assert tp.take(w, 1, 32, 8, 16) is w
    assert tp.span(32) == (8, 16)


@pytest.mark.parametrize("shape,rank,model,batch,coord", [
    ((2, 2), 3, [2, 3], [1, 3], [1, 1]),
    ((1, 4), 2, "world", None, [0, 2]),
    ((2, 2, 2), 5, [4, 5], [1, 3, 5, 7], [1, 0, 1]),
    ((4, 1), 2, None, "world", [2, 0])])
def test_axis_groups_and_coordinates(shape, rank, model, batch, coord):
    """The rank mesh's groups, made in one order on every rank: a model
    group of consecutive ranks, a batch group of the ranks sharing the
    model index (over pod and data), the world where an axis holds
    every rank, none where the model axis is 1; the row-major
    coordinate."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    made = []
    got = mesh_lib.axis_groups(shape, rank, lambda rs: made.append(rs) or
                               tuple(rs))
    n, m = int(np.prod(shape)), shape[-1]
    # Every group of both axes is made on every rank alike.
    assert len(made) == (0 if m == 1 or n == m else n // m + m)
    world = dist.group.WORLD
    want_model = world if model == "world" else (
        None if model is None else tuple(model))
    assert got.get("model") == want_model
    if batch == "world":
        assert "batch" not in got and shape[-1] == 1
    else:
        assert got.get("batch") == (None if batch is None else tuple(batch))
    assert mesh_lib._RowMajor(shape, rank).get_coordinate() == coord

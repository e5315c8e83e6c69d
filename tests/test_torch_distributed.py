"""The port's training and serving on several processes, on the CPU over
gloo: ``launch.mesh.init_distributed``, the trainer's parameter shards
(``distributed.fsdp``) against the one-process launcher, elastic resume
across rank counts (the JAX ``Checkpointer`` restoring the sharded run's
checkpoint), the reference's 1 -> 4 -> 2 ``reshard_state`` round trip,
and the serving launcher under ``--distributed``.

Each test starts its processes with the ``env://`` variables torchrun
sets (or the launcher's ``--coordinator`` flags) and joins them under a
time limit of its own, so a hung collective fails the test instead of
the suite.  Bars: float32 compute within 1e-5 relative L2 of the
one-process run, bfloat16 within 5e-2."""

import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
LIMIT_S = 120          # each test's processes, joined under this limit
F32_BAR, BF16_BAR = 1e-5, 5e-2

# Each rank runs every job of a JSON list through the launcher's main and
# rank 0 writes the gathered train state of each (the checkpoint tree)
# to the job's ``out`` as an npz.
WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.training import train_loop

    torch.set_num_threads(1)
    orig = train.get_smoke_config

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{pre}/{k}" if pre else str(k)))
            return out
        if isinstance(tree, list):
            out = {}
            for i, v in enumerate(tree):
                out.update(flat(v, f"{pre}/{i}"))
            return out
        return {pre: np.asarray(tree.detach().cpu() if
                                isinstance(tree, torch.Tensor) else tree)}

    for job in json.loads(sys.argv[1]):
        seq = job.get("seq")
        def smoke(name, seq=seq):
            arch = orig(name)
            if not seq:
                return arch
            return dataclasses.replace(arch, shapes=tuple(
                dataclasses.replace(s, seq_len=seq) if s.name == "train_4k"
                else s for s in arch.shapes))
        train.get_smoke_config = smoke
        state, hist = train.main(job["argv"])
        tree = train_loop.state_tree(state)
        if not dist.is_initialized() or dist.get_rank() == 0:
            np.savez(job["out"], **flat(tree))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(rank=None, world=None, port=None):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    if rank is not None:
        env.update(RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
    return env


def _start(ranks, argv_of, env_of=None):
    """One process a rank (``argv_of(rank)``; ranks 0 means one process
    without the env:// variables)."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, *argv_of(r)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=(env_of or (lambda r: _env(r if ranks else None, ranks, port)))(r))
        for r in range(max(ranks, 1))]


def _join(*groups, limit=LIMIT_S):
    """Join groups of processes started together under ``limit`` seconds
    in all; returns each group's [(returncode, stdout + stderr)]."""
    procs = [p for g in groups for p in g]
    out = {}
    try:
        for p in procs:
            text, _ = p.communicate(timeout=limit)
            out[p] = (p.returncode, text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [[out[p] for p in g] for g in groups]


def _run(ranks, argv_of, env_of=None):
    return _join(_start(ranks, argv_of, env_of))[0]


def _worker(ranks, jobs):
    return _start(ranks, lambda r: ["-c", WORKER, json.dumps(jobs)])


def _train(*groups):
    """Run (ranks, jobs) groups of the worker at once; each must exit 0."""
    for res in _join(*(_worker(n, jobs) for n, jobs in groups)):
        for rc, text in res:
            assert rc == 0, text[-4000:]


def _rel(a, b, prefix):
    keys = [k for k in a.files if k.startswith(prefix + "/")]
    assert keys and sorted(keys) == sorted(k for k in b.files
                                           if k.startswith(prefix + "/"))
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2))
              for k in keys)
    den = sum(float(np.sum(a[k].astype(np.float64) ** 2)) for k in keys)
    return (num / den) ** 0.5


# Flags only: the config overrides go last (argparse takes one run of
# positionals).  Every run takes 2 micro-batches a step.
DIT = ["--arch", "dit-b2", "--shape", "train_256", "--smoke",
       "--batch-override", "4", "--device", "cpu"]
MOE = ["--arch", "qwen2-moe-a2.7b", "--shape", "train_4k", "--smoke",
       "--batch-override", "4", "--device", "cpu"]
ACCUM = ["train.grad_accum=2"]
CASES = {f"{name}-{dt}{'-int8' if comp else ''}": (argv, dt, comp)
         for name, argv in (("dit-b2", DIT), ("qwen2-moe", MOE))
         for dt in ("float32", "bfloat16") for comp in (False, True)}


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    """Every case of CASES for 3 steps, by the one-process launcher and by
    2 ranks (one process a rank), each rank running all of them."""
    d = tmp_path_factory.mktemp("parity")
    jobs = {n: [] for n in (0, 2)}
    for case, (argv, dt, comp) in CASES.items():
        over = ACCUM + [f"train.compute_dtype={dt}",
                f"train.grad_compression={str(comp).lower()}"]
        if case.startswith("dit-b2-float32") and not comp:
            over.append("train.ema_decay=0.9")
        for n in jobs:
            jobs[n].append({"argv": argv + ["--steps", "3"] + over,
                            "out": str(d / f"{case}-{n}.npz"), "seq": 32})
    _train(*jobs.items())
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_one(parity_runs, case):
    """2 ranks against the one-process launcher, 3 AdamW steps with 2
    micro-batches a step: params, moments (and the EMA, the residuals)
    within the dtype's bar; the step counts equal."""
    _, dt, comp = CASES[case]
    one = np.load(parity_runs / f"{case}-0.npz")
    two = np.load(parity_runs / f"{case}-2.npz")
    bar = F32_BAR if dt == "float32" else BF16_BAR
    assert int(one["opt/step"]) == int(two["opt/step"]) == 3
    assert _rel(one, two, "params") <= bar
    if dt == "float32" and not comp:
        for part in ("opt/mu", "opt/nu"):
            assert _rel(one, two, part) <= 1e-4, part
    if "ema/patch/w" in one.files:
        assert _rel(one, two, "ema") <= bar
    assert ("compression/error/patch/w" in two.files
            or "compression/error/embed" in two.files) == comp


def test_elastic_resume_at_one_and_four_ranks(tmp_path):
    """A 2-rank run checkpoints at step 2; resumed at 1 and at 4 ranks to
    step 4 it ends within the f32 bar of the uninterrupted one-process
    run; the JAX package's ``Checkpointer`` restores the 2-rank
    checkpoint into the reference's train state."""
    import jax

    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch.workloads import model_fns
    from repro.models.params import init_params
    from repro.training import train_loop as j_loop

    over = ACCUM + ["train.compute_dtype=float32"]
    # batch 8: each micro-batch's 4 rows split over 4 ranks, so no rank
    # count clamps grad_accum (a clamp would draw other noise)
    dit = [a if a != "4" else "8" for a in DIT]
    ck2 = tmp_path / "ck2"
    _train((2, [{"argv": dit + ["--steps", "2", "--ckpt-every", "2",
                                "--ckpt-dir", str(ck2)] + over,
                 "out": str(tmp_path / "two.npz")}]),
           (0, [{"argv": dit + ["--steps", "4"] + over,
                 "out": str(tmp_path / "whole.npz")}]))
    for n in (1, 4):
        shutil.copytree(ck2, tmp_path / f"ck{n}")
    _train(*((n, [{"argv": dit + ["--steps", "4", "--ckpt-dir",
                                  str(tmp_path / f"ck{n}")] + over,
                   "out": str(tmp_path / f"at{n}.npz")}]) for n in (1, 4)))
    whole = np.load(tmp_path / "whole.npz")
    for n in (1, 4):
        got = np.load(tmp_path / f"at{n}.npz")
        assert int(got["opt/step"]) == 4
        assert _rel(whole, got, "params") <= F32_BAR, n
    arch = j_smoke("dit-b2")
    params = init_params(model_fns(arch), jax.random.PRNGKey(0))
    template = j_loop.train_state_init(params, arch.train)
    step, restored, _ = JCheckpointer(str(ck2), async_save=False) \
        .restore_latest(template)
    assert step == 2 and int(restored.opt.step) == 2
    two = np.load(tmp_path / "two.npz")
    np.testing.assert_array_equal(np.asarray(restored.params["patch"]["w"]),
                                  two["params/patch/w"])


RESHARD = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import init_distributed, make_rank_mesh

    init_distributed(device="cpu")
    mesh = make_rank_mesh(device="cpu")
    whole = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[1]).items()}
    axes = {"w": ("embed", "mlp"), "b": ("embed",), "r": (None, "embed")}
    piece = reshard_state(whole, axes, mesh)
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, {k: v.numpy() for k, v in piece.items()})
    if dist.get_rank() == 0:
        np.savez(sys.argv[2], **{k: np.concatenate([g[k] for g in got],
                                                  axis={"w": 0, "b": 0,
                                                        "r": 1}[k])
                                 for k in whole})
    dist.barrier()
    dist.destroy_process_group()
""")


def test_reshard_one_to_four_to_two_round_trip(tmp_path):
    """The reference's elastic test over ranks: whole arrays cut by their
    rule-table specs onto 4 ranks, gathered, cut onto 2 and gathered
    again come back bit-equal (an ``embed`` dim of 8 over 4 and 2 data
    ranks; an odd one replicated)."""
    rng = np.random.default_rng(0)
    src = {"w": rng.standard_normal((8, 16)).astype(np.float32),
           "b": rng.standard_normal((8,)).astype(np.float32),
           "r": rng.standard_normal((3, 8)).astype(np.float32)}
    np.savez(tmp_path / "one.npz", **src)
    paths = [tmp_path / "one.npz", tmp_path / "four.npz", tmp_path / "two.npz"]
    for n, a, b in ((4, paths[0], paths[1]), (2, paths[1], paths[2])):
        res = _run(n, lambda r, a=a, b=b: ["-c", RESHARD, str(a), str(b)])
        for rc, text in res:
            assert rc == 0, text[-4000:]
    got = np.load(paths[2])
    for k, v in src.items():
        np.testing.assert_array_equal(got[k], v)


INIT = textwrap.dedent("""
    import sys
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed

    addr, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    try:
        first = init_distributed(addr, world, rank, device="cpu",
                                 timeout_s=float(sys.argv[4]))
    except Exception as e:  # the unreachable coordinator
        print("RAISED", type(e).__name__)
        raise SystemExit(3)
    again = init_distributed(device="cpu")
    print("INIT", first, again, dist.get_backend(), dist.get_world_size())
    dist.destroy_process_group()
""")


def test_init_distributed_real_idempotent_and_unreachable():
    """A real init over gloo (a one-process group at a local coordinator)
    returns True and a second call False; a rank whose coordinator
    cannot be reached raises instead of carrying on as one process."""
    real, dead = _free_port(), _free_port()  # nothing listens at ``dead``
    [[(rc, text)], [(rc2, text2)]] = _join(
        _start(1, lambda r: ["-c", INIT, f"127.0.0.1:{real}", "1", "0", "30"],
               env_of=lambda r: _env()),
        _start(1, lambda r: ["-c", INIT, f"127.0.0.1:{dead}", "2", "1", "1"],
               env_of=lambda r: _env()))
    assert rc == 0 and "INIT True False gloo 1" in text, text[-2000:]
    assert rc2 == 3 and "RAISED" in text2, text2[-2000:]


def test_serving_launcher_distributed_at_two_ranks(tmp_path):
    """``python -m repro_torch.launch.serve --distributed --device cpu
    --smoke --requests 2`` at 2 ranks (``--coordinator`` flags): each
    process joins the group, serves both requests through its own engine
    and writes its summary."""
    port = _free_port()

    def argv(r):
        return ["-m", "repro_torch.launch.serve", "--distributed",
                "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                "--process-id", str(r), "--device", "cpu", "--smoke",
                "--shape", "gen_512", "--requests", "2", "--summary-json",
                str(tmp_path / f"s{r}.json")]

    res = _run(2, argv, env_of=lambda r: _env())
    for r, (rc, text) in enumerate(res):
        assert rc == 0, text[-4000:]
        assert f"process {r} of 2 on cpu" in text
        summary = json.loads((tmp_path / f"s{r}.json").read_text())
        assert sorted(summary["completed"]) == [0, 1]

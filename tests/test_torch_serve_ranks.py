"""Serving over a dispatch mesh that spans processes, on the CPU over
gloo: the launcher's ``--distributed --mesh 2x2`` at 2 ranks against the
one-process ``--mesh 2x2`` and the unsharded run, the flags it refuses
there, and the engine's lockstep (``serving/lockstep.py``): a rank whose
clock and submit order are skewed serves rank 0's batches, rank 0's
sheds reach it, and a mismatched or missing request raises on every rank
within the limit.  Processes start as ``tests/test_torch_distributed.py``
starts them and are joined under its ``LIMIT_S``."""

import json
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import (_env, _free_port, _join,  # noqa: E402
                                    _start)

# Each job of the JSON list through the launcher's main; the latents of
# a run that ends go to job["out"] (an npz by request id), a refused
# one's exit code to job["out"] + ".exit".
LAUNCH = textwrap.dedent(r"""
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.launch import serve

    torch.set_num_threads(1)
    for job in json.loads(sys.argv[1]):
        try:
            done = serve.main(job["argv"])
        except SystemExit as e:
            open(job["out"] + ".exit", "w").write(str(e.code))
            continue
        np.savez(job["out"], **{str(r.request_id): r.latents for r in done})
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
""")

SMOKE = ["--device", "cpu", "--smoke", "--requests", "6"]
REFUSED = {"replicas": ["--replicas", "2"],
           "journal": ["--journal", "JOURNAL"],
           "faults": ["--inject-faults", "attn_nan:step=1"]}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """6 requests over 3 buckets: ``--distributed --mesh 2x2`` at 2 ranks
    (2 shards a rank), then each refused flag there; the one-process
    ``--mesh 2x2`` (4 shards); the unsharded run.  Returns the output
    directory and each rank's log."""
    d = tmp_path_factory.mktemp("served")
    port = _free_port()

    def dist_jobs(r):
        flags = ["--distributed", "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "2", "--process-id", str(r), "--mesh",
                 "2x2"]
        jobs = [{"argv": SMOKE + flags + ["--summary-json",
                                          str(d / f"summary-{r}.json")],
                 "out": str(d / f"dist-{r}.npz")}]
        for name, extra in REFUSED.items():
            extra = [str(d / f"j{r}") if a == "JOURNAL" else a for a in extra]
            jobs.append({"argv": SMOKE + flags + extra,
                         "out": str(d / f"{name}-{r}")})
        return ["-c", LAUNCH, json.dumps(jobs)]

    def one(name, force, extra):
        job = [{"argv": SMOKE + extra, "out": str(d / f"{name}.npz")}]
        return _start(1, lambda r: ["-c", LAUNCH, json.dumps(job)],
                      env_of=lambda r: dict(
                          _env(), REPRO_TORCH_FORCE_DEVICE_COUNT=force))

    ranks, mesh1, plain = _join(
        _start(2, dist_jobs, env_of=lambda r: dict(
            _env(), REPRO_TORCH_FORCE_DEVICE_COUNT="2")),
        one("mesh", "4", ["--mesh", "2x2"]), one("plain", "1", []))
    for rc, text in ranks + mesh1 + plain:
        assert rc == 0, text[-4000:]
    return d, [text for _, text in ranks]


def test_launcher_mesh_over_two_ranks_equals_one_process(served):
    """Every rank's 6 completions bit-equal to the one-process ``--mesh
    2x2`` run's and to the unsharded run's; each rank logs its process,
    the mesh's coordinates by rank and the sharded plan lines; the
    summaries' completion digests agree."""
    d, logs = served
    mesh1, plain = np.load(d / "mesh.npz"), np.load(d / "plain.npz")
    assert sorted(mesh1.files, key=int) == [str(i) for i in range(6)]
    for r in range(2):
        got = np.load(d / f"dist-{r}.npz")
        assert sorted(got.files) == sorted(mesh1.files)
        for rid in got.files:
            np.testing.assert_array_equal(got[rid], mesh1[rid])
            np.testing.assert_array_equal(got[rid], plain[rid])
        text = logs[r]
        assert f"process {r} of 2 on cpu" in text
        assert "dispatch mesh: rank 0 holds [(0, 0), (0, 1)]" in text
        assert "dispatch mesh: rank 1 holds [(1, 0), (1, 1)]" in text
        assert "bucket gen_512 at batch 2: plan attention[ripple/reference " \
               "shard=batch2xheads2" in text
        assert "completions equal on every one of 2 ranks" in text
    s0, s1 = (json.loads((d / f"summary-{r}.json").read_text())
              for r in range(2))
    assert sorted(s0["completed"]) == sorted(s1["completed"]) == list(range(6))
    assert s0["completion_digests"] == s1["completion_digests"]
    assert len(s0["completion_digests"]) == 6


@pytest.mark.parametrize("flag", sorted(REFUSED))
def test_flags_refused_under_a_mesh_over_ranks(served, flag):
    """``--replicas 2``, ``--journal`` and fault injection are refused at
    argument parsing on every rank, naming the mesh that spans
    processes: each would decide on its own rank's clock or disk."""
    d, logs = served
    for r in range(2):
        assert (d / f"{flag}-{r}.exit").read_text() == "2"
        assert "is not supported under a dispatch mesh that spans " \
               "processes" in logs[r]
    assert not (d / "j0").exists()


# The engine at 2 ranks with a toy sampler that all-reduces over the
# group once a batch, as a sharded call's collectives do.  Rank 1's clock
# runs 1000 s ahead and it submits in reverse order, one request every
# 50 ms after its worker started; rank 0 submits first.  Request 7's
# deadline has passed, so rank 0 sheds it.  ``mismatch``: rank 1's
# request 3 has another seed; ``missing``: rank 1 never gets request 3;
# ``hang``: a 1 s watchdog, and rank 1's first batch sleeps 3 s (no
# collective in that sampler, so rank 0's batch ends in time).
LOCKSTEP = textwrap.dedent(r"""
    import hashlib, json, os, sys, time
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.serving import engine as eng_lib
    from repro_torch.serving.engine import DiffusionEngine, GenRequest
    from repro_torch.serving.lockstep import Lockstep
    from repro_torch.serving.slo import ShedError

    port, mode, out = sys.argv[1], sys.argv[2], sys.argv[3]
    rank = int(os.environ["RANK"])
    init_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu",
                     timeout_s=30)
    eng_lib.LOCKSTEP_WAIT_S = 3.0
    if rank == 1:
        real = time.time
        time.time = lambda: real() + 1000.0

    calls = []

    def factory(shape, steps):
        def fn(noise, txt, seeds):
            calls.append(1)
            if mode == "hang":
                if rank == 1 and len(calls) == 1:
                    time.sleep(3.0)
                return noise * steps
            n = torch.tensor([float(len(seeds))])
            dist.all_reduce(n)
            return noise * steps + txt.mean() + n
        return fn

    shapes = [(4, 4, 4, 2), (4, 2, 2, 2), (2, 4, 4, 2)]
    reqs = []
    for i in range(8):
        seed = 99 if (mode == "mismatch" and rank == 1 and i == 3) else i
        reqs.append(GenRequest(
            request_id=i, txt=np.full((3, 5), i, np.float32),
            latent_shape=shapes[i % 3], steps=2 + i % 2, seed=seed,
            deadline_s=time.time() - 1.0 if i == 7 else None))
    if mode == "missing" and rank == 1:
        reqs = [r for r in reqs if r.request_id != 3]
    eng = DiffusionEngine(factory, device="cpu", max_batch=2,
                          max_wait_s=0.01, scheduler="hottest",
                          batch_timeout_s=1.0 if mode == "hang" else None,
                          lockstep=Lockstep(30))
    shed = set()

    def submit(r):
        try:
            eng.submit(r)
        except ShedError:
            shed.add(r.request_id)

    if rank == 0:
        for r in reqs:
            submit(r)
        eng.start()
    else:
        eng.start()
        for r in reversed(reqs):
            time.sleep(0.05)
            submit(r)
    got = {}
    for r in reqs:
        if r.request_id in shed:
            got[r.request_id] = ["shed"]
            continue
        try:
            res = eng.result(r.request_id, timeout=90)
            got[r.request_id] = ["ok", res.batch_index, hashlib.sha256(
                res.latents.tobytes()).hexdigest()]
        except ShedError:
            got[r.request_id] = ["shed"]
        except RuntimeError as e:
            got[r.request_id] = ["error", str(e)]
    eng.stop()
    json.dump({"got": got, "digests": eng.batch_digests,
               "error": eng.lockstep_error, "trips": eng.watchdog_trips},
              open(f"{out}-{rank}.json", "w"))
    dist.barrier()
    dist.destroy_process_group()
""")

MODES = ("skew", "mismatch", "missing", "hang")


@pytest.fixture(scope="module")
def lockstep_runs(tmp_path_factory):
    """Each mode at 2 ranks, all at once; mode -> (rank 0's, rank 1's)
    records."""
    d = tmp_path_factory.mktemp("lockstep")
    groups = []
    for mode in MODES:
        port = _free_port()
        groups.append(_start(2, lambda r, mode=mode, port=port: [
            "-c", LOCKSTEP, str(port), mode, str(d / mode)],
            env_of=lambda r, port=port: _env(r, 2, port)))
    out = {}
    for mode, res in zip(MODES, _join(*groups)):
        for rc, text in res:
            assert rc == 0, text[-4000:]
        out[mode] = tuple(json.loads((d / f"{mode}-{r}.json").read_text())
                          for r in range(2))
    return out


def test_a_skewed_rank_serves_rank_0s_batches(lockstep_runs):
    """Rank 1, its clock 1000 s ahead and its requests submitted in
    reverse order while its worker runs, serves the batches rank 0
    chose: the same requests in the same batch indices with the same
    latents, equal batch digests, and rank 0's shed of request 7 seen as
    a shed."""
    r0, r1 = lockstep_runs["skew"]
    assert r0["error"] is None and r1["error"] is None
    assert r0["got"] == r1["got"]
    assert r0["got"]["7"] == ["shed"]
    assert all(r0["got"][str(i)][0] == "ok" for i in range(7))
    assert r0["digests"] == r1["digests"] and len(r0["digests"]) >= 4
    batches = {}
    for rid, (_, bi, _) in ((k, v) for k, v in r0["got"].items()
                            if v[0] == "ok"):
        batches.setdefault(bi, []).append(int(rid))
    assert max(len(b) for b in batches.values()) == 2


@pytest.mark.parametrize("mode", ["mismatch", "missing"])
def test_a_mismatched_batch_raises_on_every_rank(lockstep_runs, mode):
    """Rank 1's request 3 differs (another seed) or never arrives: the
    batch digests disagree, and on both ranks the engine stops with the
    lockstep error, request 3 fails and the batches before it stand."""
    r0, r1 = lockstep_runs[mode]
    for rec in (r0, r1):
        assert rec["error"] and "the ranks disagree" in rec["error"]
    assert r0["got"]["3"][0] == "error" and "lockstep" in r0["got"]["3"][1]
    if mode == "mismatch":
        assert r1["got"]["3"] == r0["got"]["3"]
    else:
        assert "3" not in r1["got"]
    assert r0["digests"] == r1["digests"]


def test_a_hang_on_one_rank_trips_the_watchdog_on_every_rank(lockstep_runs):
    """Rank 1's first batch outlives rank 0's 1 s budget while rank 0's
    ends in time: the verdicts are agreed, so both ranks trip the
    watchdog once and fail the batch and the queue over, and neither
    serves a batch the other did not."""
    r0, r1 = lockstep_runs["hang"]
    assert r0["trips"] == r1["trips"] == 1
    for rec in (r0, r1):
        assert rec["error"] is None
        assert all(v[0] in ("error", "shed") for v in rec["got"].values())
        assert any("watchdog" in v[1] for v in rec["got"].values()
                   if v[0] == "error")
    assert r0["digests"] == r1["digests"] and len(r0["digests"]) == 1

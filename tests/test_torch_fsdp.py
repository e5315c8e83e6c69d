"""The trainer's parameter shards (``distributed.fsdp``) block by block:
each module ``block_units`` names is one that its family's training
forward runs through ``remat_call``; at 2 ranks over gloo every training family
the other tests do not cover (flux-dev, unet-sd15, vdit-paper, vit-l16,
efficientnet-b7, smoke configs, float32 compute) ends within 1e-5
relative L2 of the one-process launcher, while no more than one call's
blocks are whole at a time and each block's gradients are reduced by
its own last accumulation, not by the end-of-micro-batch sweep."""

import json
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import (F32_BAR, WORKER, _env,  # noqa: E402
                                    _free_port, _join, _rel, _start)

# family -> (arch, train shape)
FAMILIES = {"dit": ("dit-b2", "train_256"), "mmdit": ("flux-dev", "train_256"),
            "unet": ("unet-sd15", "train_256"), "vdit": ("vdit-paper", "train_256"),
            "vit": ("vit-l16", "cls_224"), "effnet": ("efficientnet-b7", "cls_224"),
            "lm": ("qwen2-moe-a2.7b", "train_4k")}
# The families test_torch_distributed does not train at 2 ranks.
OTHERS = ("mmdit", "unet", "vdit", "vit", "effnet")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_block_units_are_the_remat_calls(family):
    """One training forward of the smoke model under ``block_hook``: every
    module of ``block_units(model)`` is among those ``remat_call`` was
    given, so every block is gathered where it runs (the rest, a UNet's
    middle blocks among it, belongs to the root, whole for the step)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import DataSpec, batch_generator
    from repro_torch.distributed.fsdp import block_units
    from repro_torch.launch import workloads
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.common import block_hook
    from repro_torch.models.params import init_model

    name, shape_name = FAMILIES[family]
    arch = get_smoke_config(name)
    shape = arch.shape(shape_name)
    field = "global_batch" if arch.family == "lm" else "batch"
    shape = type(shape)(**{**shape.__dict__, field: 2,
                           **({"seq_len": 16} if arch.family == "lm" else {})})
    model = init_model(arch.model, seed=0, device="cpu")
    batch = make_batch_fn(arch, shape, "cpu")(DataSpec(seed=0), 0)
    seen = []

    def hook(call, modules):
        seen.extend(id(m) for m in modules)
        return call()

    loss_fn = workloads.train_loss_fn(arch)
    with torch.enable_grad(), block_hook(hook):
        loss, _ = loss_fn(model, batch, batch_generator(0, 0, 0))
    assert torch.isfinite(loss)
    units = {id(m) for m in block_units(model)}
    assert units and units <= set(seen)


# Run before the worker: every ParamShards counts, per instance, the
# most block parameters whole at once, the most one call gathers, and
# the block reductions made by a block's own trigger or by the sweep;
# rank 0 writes the counts at exit.
PROBE = textwrap.dedent("""
    import atexit, json, os
    from repro_torch.distributed import fsdp

    stats = []
    Shards = fsdp.ParamShards
    init, gather, run, reduce = (Shards.__init__, Shards._gather_params,
                                 Shards._run_block, Shards._reduce)

    def init_(self, *a, **k):
        self.stats = {"whole": 0, "call": 0, "own": 0, "sweep": 0}
        stats.append(self.stats)
        init(self, *a, **k)

    def gather_(self, idx):
        gather(self, idx)
        self.stats["whole"] = max(self.stats["whole"], len(
            [i for i in self._whole if i not in self.root]))

    def run_(self, call, modules):
        self.stats["call"] = max(self.stats["call"], sum(
            len(self.units.get(id(m), ())) for m in modules))
        return run(self, call, modules)

    def reduce_(self, idx):
        idx = list(idx)
        blocks = [i for i in idx if i not in self.root]
        if blocks:
            swept = len(blocks) == len(self.params) - len(self.root)
            self.stats["sweep" if swept else "own"] += 1
        reduce(self, idx)

    Shards.__init__, Shards._gather_params = init_, gather_
    Shards._run_block, Shards._reduce = run_, reduce_
    if os.environ.get("RANK") == "0":
        atexit.register(lambda: open(os.environ["FSDP_STATS"], "w").write(
            json.dumps(stats)))
""")


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    """Every family of OTHERS for 2 steps of 2 micro-batches (batch 4,
    float32 compute), by the one-process launcher and by 2 ranks."""
    d = tmp_path_factory.mktemp("families")
    jobs = {n: [] for n in (0, 2)}
    for fam in OTHERS:
        name, shape = FAMILIES[fam]
        for n in jobs:
            jobs[n].append({"argv": ["--arch", name, "--shape", shape,
                                     "--smoke", "--batch-override", "4",
                                     "--device", "cpu", "--steps", "2",
                                     "train.grad_accum=2",
                                     "train.compute_dtype=float32"],
                            "out": str(d / f"{fam}-{n}.npz")})
    stats = d / "stats.json"
    groups = []
    for n, js in jobs.items():
        port = _free_port()
        groups.append(_start(n, lambda r, js=js: ["-c", PROBE + WORKER,
                                                  json.dumps(js)],
                             env_of=lambda r, n=n, port=port: dict(
                                 _env(r if n else None, n, port),
                                 FSDP_STATS=str(stats))))
    for res in _join(*groups):
        for rc, text in res:
            assert rc == 0, text[-4000:]
    return d, json.loads(stats.read_text())


@pytest.mark.parametrize("family", OTHERS)
def test_two_ranks_match_one_per_family(family_runs, family):
    """2 ranks against the one-process launcher: params within the f32
    bar after 2 steps."""
    d, _ = family_runs
    one = np.load(d / f"{family}-0.npz")
    two = np.load(d / f"{family}-2.npz")
    assert int(one["opt/step"]) == int(two["opt/step"]) == 2
    assert _rel(one, two, "params") <= F32_BAR


def test_blocks_are_whole_one_call_at_a_time(family_runs):
    """In each family's 2-rank run (rank 0): at no time were more block
    parameters whole than the most one call gathers, and every block's
    gradients were reduced by its own last accumulation, none by the
    end-of-micro-batch sweep."""
    _, stats = family_runs
    assert len(stats) == len(OTHERS)
    for s in stats:
        assert s["own"] > 0 and s["sweep"] == 0, stats
        assert 0 < s["whole"] <= s["call"], stats

"""The transformer diffusion and vision train steps on a (data x model)
rank mesh, on the CPU over gloo: heads and MLP tensor-parallel on
``model`` (``distributed.tensor_parallel``), attention over query rows
where the heads do not divide the axis (the reference's
``_attn_seq_fallback``), FSDP over ``data`` (``distributed.fsdp``).

The weights are the reference's init (``init_params`` of the JAX
package), every leaf moved by seeded noise so that no adaLN gate or
output layer is zero, passed across through numpy
(``models.params.params_from_numpy``) and cut into each rank's pieces by
``train_state_init``.  The train config learns at 1e-3 after a warmup of
one step, so the params move.

* N ranks against one process: the smoke vdit-paper (2 heads: the
  query-row region at model 4), dit-xl2, flux-dev and vit-l16 at (data,
  model) = (1, 2), (2, 2) and (1, 4), and flux-dev cut to 3 heads of 32
  (the query-row region at model 2), 3 AdamW steps in float32: the
  per-step losses within 1e-5 relative, the final params within 1e-5
  relative L2, the first moments within 1e-4.
* Against the reference: at (2, 2) one micro-batch's loss and
  gradients against ``jax.value_and_grad`` of the reference's
  ``_diffusion_train`` / ``_vision_train`` loss jitted on a (2, 2) mesh
  of 4 virtual CPU devices under its rules (``_attn_seq_fallback``'s
  included), with the port's batch, noise and timesteps passed across
  through numpy: within 1e-5.
* The pieces: the four trees' 2-D pieces are the reference's specs
  (its drops where a dim does not divide included), whole over the
  batch group only."""

import dataclasses
import json
import os
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.launch.workloads import model_fns  # noqa: E402
from repro.models.params import init_params, logical_axes  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import _join  # noqa: E402
from test_torch_tp import _check, _max_rel, _rel, _start  # noqa: E402

LIMIT_S = 120
ARCHS = ("vdit-paper", "dit-xl2", "flux-dev", "vit-l16")
MESHES = ((1, 2), (2, 2), (1, 4))
BATCH, STEPS = 4, 3
# Each smoke config's train shape and the resolution it is cut to:
# vdit-paper 8 text + (4, 2, 2) video tokens, dit-xl2 4 x 4, flux-dev 8
# text + 4 x 4 image tokens, vit-l16 the cls token + 4 x 4.
SHAPES = {"vdit-paper": ("train_256", 32), "dit-xl2": ("train_256", 64),
          "flux-dev": ("train_256", 64), "vit-l16": ("cls_224", 32)}
# flux-dev with heads that do not divide a model axis of 2.
HEADS3 = ("flux-dev", {"d_model": 96, "num_heads": 3, "axes_dim": [8, 12, 12]})

# Each process runs its JSON list of jobs: a smoke config cut to SHAPES,
# its params from ``init`` (a flat npz of the reference's tree), on a
# rank mesh of model axis ``model`` (none without the env:// variables):
# ``steps`` AdamW steps from ``start`` (restoring the checkpoint in
# ``ckpt`` when it holds one), or with ``grads`` one micro-batch's loss
# and gradients.  Rank 0 writes the per-step losses, the state tree at
# the end (``out``), the restored tree, and how many of its joins were
# over the sequence (the query-row region's).
WORKER = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import DataSpec, batch_generator
    from repro_torch.distributed.tensor_parallel import TensorParallel
    from repro_torch.launch import workloads
    from repro_torch.launch.mesh import init_distributed, make_rank_mesh
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.params import jax_tree, params_from_numpy
    from repro_torch.training import train_loop

    torch.set_num_threads(1)
    ranked = "RANK" in os.environ
    if ranked:
        init_distributed(device="cpu")
    rank0 = not ranked or dist.get_rank() == 0
    joins = []  # (rank of the tensor, dim) of each join
    join = TensorParallel.join
    TensorParallel.join = lambda self, x, dim, n: (
        joins.append((x.dim(), dim)), join(self, x, dim, n))[1]

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

    def nest(arrays):
        root = {}
        for key, a in arrays.items():
            *path, last = key.split("/")
            node = root
            for p in path:
                node = node.setdefault(p, {})
            node[last] = a
        return root

    def cut(job):
        arch = get_smoke_config(job["arch"])
        over = {k: tuple(v) if isinstance(v, list) else v
                for k, v in job.get("over", {}).items()}
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, **over))
        shape = dataclasses.replace(arch.shape(job["shape"]),
                                    img_res=job["res"], batch=job["batch"])
        return dataclasses.replace(arch, shapes=(shape,),
                                   train=dataclasses.replace(
            arch.train, compute_dtype="float32", learning_rate=1e-3,
            warmup_steps=1)), shape

    for job in json.loads(sys.argv[1]):
        arch, shape = cut(job)
        mesh = (make_rank_mesh(model_axis=job["model"], device="cpu")
                if ranked else None)
        model = params_from_numpy(nest(dict(np.load(job["init"]))),
                                  arch.model, device="cpu")
        state = train_loop.train_state_init(model, arch.train, mesh=mesh)
        fn = make_batch_fn(arch, shape, "cpu")
        del joins[:]
        if job.get("grads"):
            sh = state.shards
            loss_fn = workloads.train_loss_fn(arch,
                                              workloads.train_ctx(arch, mesh))
            per = shape.batch // sh.n
            rows = slice(sh.index * per, (sh.index + 1) * per)
            with torch.enable_grad(), sh.step():
                loss, _ = loss_fn(model, fn(DataSpec(seed=0), 0),
                                  batch_generator(0, 0, 0), rows=rows)
                loss.backward()
                sh.end_micro_batch()
                grads = sh.take_grads()
            whole = sh.gather_full(grads)
            loss = float(sh.mean(loss.detach()))
            index = {id(p): i for i, p in enumerate(model.parameters())}
            tree = jax_tree(model, lambda p: whole[index[id(p)]])
            if rank0:
                np.savez(job["out"], loss=loss, **flat({"grads": tree}))
            continue
        step = workloads.train_step(arch, shape, model, mesh=mesh)
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
        losses = []
        for i in range(start, job["steps"]):
            state, m = step(state, fn(DataSpec(seed=0), i), 0)
            losses.append(float(m["loss"]))
        tree = train_loop.state_tree(state)
        if ckpt is not None and rank0:
            ckpt.save(job["steps"], tree)
            ckpt.wait()
        if rank0:
            np.savez(job["out"], **flat(tree), **{
                "hist/loss": np.array(losses),
                "seq_joins": np.array(joins.count((3, 1)))})
    if ranked:
        dist.barrier()
        dist.destroy_process_group()
""")

# The reference's loss of each job's first micro-batch and its gradients
# (``jax.value_and_grad``, jitted on a (2, 2) mesh of 4 virtual devices
# with the params sharded by its rule tables), under its rules: the
# diffusion loss body of ``_diffusion_train`` with the noise and t the
# port draws, the vision loss of ``_vision_train``, float32 compute.
REFERENCE = textwrap.dedent("""
    import dataclasses, functools, json, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import torch
    from repro.configs import get_smoke_config as j_smoke
    from repro.diffusion.schedule import DDPMSchedule, RectifiedFlowSchedule
    from repro.distributed import sharding as shlib
    from repro.launch import workloads as jw
    from repro.models import dit, mmdit, vdit, vit
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import DataSpec, batch_generator
    from repro_torch.launch import workloads
    from repro_torch.launch.train import make_batch_fn

    for mod, name in ((dit, "dit_apply"), (vdit, "vdit_apply"),
                      (mmdit, "mmdit_apply"), (vit, "vit_apply")):
        setattr(mod, name, functools.partial(getattr(mod, name),
                                             compute_dtype=jnp.float32))
    # GSPMD's sharding constraints need the mesh's axes to be Auto.
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)

    def nest(arrays):
        root = {}
        for key, a in arrays.items():
            *path, last = key.split("/")
            node = root
            for p in path:
                node = node.setdefault(p, {})
            node[last] = jnp.asarray(a)
        return root

    def flat(t, pre=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(flat(v, f"{pre}/{k}" if pre else k))
            return out
        return {pre: np.asarray(t)}

    for job in json.loads(sys.argv[1]):
        def cut(arch):
            over = {k: tuple(v) if isinstance(v, list) else v
                    for k, v in job.get("over", {}).items()}
            arch = dataclasses.replace(arch, model=dataclasses.replace(
                arch.model, **over))
            shape = dataclasses.replace(arch.shape(job["shape"]),
                                        img_res=job["res"],
                                        batch=job["batch"])
            return arch, shape
        arch, shape = cut(get_smoke_config(job["arch"]))
        jarch, _ = cut(j_smoke(job["arch"]))
        batch = make_batch_fn(arch, shape, "cpu")(DataSpec(seed=0), 0)
        fam = arch.family
        if fam != "vit":
            noise, t = workloads.draw_diffusion_noise(
                arch, batch["latents"], batch_generator(0, 0, 0))
            batch["noise"], batch["t"] = noise, t
        batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        defs = jw.model_fns(jarch)
        _, param_sh = jw._param_shardings(defs, mesh)
        m = jarch.model
        if fam == "vit":
            ctx = shlib.ShardCtx(mesh, shlib.train_act_rules(mesh))
        else:
            ctx = shlib.ShardCtx(mesh, jw._attn_seq_fallback(
                jarch, mesh, shlib.train_act_rules(mesh)))

        def loss_fn(params, batch):
            if fam == "vit":
                logits = vit.vit_apply(params, batch["images"], m, ctx=ctx,
                                       remat=jarch.train.remat)
                logits = logits.astype(jnp.float32)
                logz = jax.nn.logsumexp(logits, axis=-1)
                gold = jnp.take_along_axis(logits, batch["labels"][:, None],
                                           1)[:, 0]
                return jnp.mean(logz - gold)
            x0, noise, t = batch["latents"], batch["noise"], batch["t"]
            if fam == "mmdit":
                rf = RectifiedFlowSchedule()
                xt = rf.interpolate(x0, noise, t)
                target = rf.velocity_target(x0, noise)
            else:
                xt = DDPMSchedule().add_noise(x0, noise, t)
                target, t = noise, t.astype(jnp.float32)
            pred = jw._denoise_call(jarch, params, xt, t, batch, None, None,
                                    ctx, use_ripple=False)
            return jnp.mean(jnp.square(pred.astype(jnp.float32)
                                       - target.astype(jnp.float32)))

        params = nest(dict(np.load(job["init"])))
        bsh = {k: jw._batch_sharding(mesh, v.ndim, size0=v.shape[0])
               for k, v in batch.items()}
        fn = jax.jit(jax.value_and_grad(loss_fn),
                     in_shardings=(param_sh, bsh))
        loss, grads = fn(params, batch)
        np.savez(job["out"], loss=float(loss), **flat({"grads": grads}))
""")


def _flat(t, pre="", leaf=np.asarray):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_flat(v, f"{pre}/{k}" if pre else k, leaf))
        return out
    return {pre: leaf(t)}


def _jarch(name, over=None):
    jarch = j_smoke(name)
    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in (over or {}).items()}
    return dataclasses.replace(jarch, model=dataclasses.replace(
        jarch.model, **over))


def write_init(path, name, over=None):
    """The reference's init of the smoke ``name`` (with model fields
    ``over``), every leaf moved by 0.02 of a seeded normal draw, as a flat
    npz of the JAX tree."""
    defs = model_fns(_jarch(name, over))
    params = jax.jit(lambda: init_params(defs, jax.random.PRNGKey(0)))()
    rng = np.random.default_rng(0)
    np.savez(path, **{k: (v + 0.02 * rng.standard_normal(v.shape))
                      .astype(np.float32)
                      for k, v in _flat(params).items()})
    return str(path)


def job(d, name, mesh, tag="", **extra):
    """A job of ``name`` on ``mesh`` (None: one process)."""
    shape, res = SHAPES[name]
    where = "one" if mesh is None else "x".join(map(str, mesh))
    return dict(arch=name, shape=shape, res=res, batch=BATCH, steps=STEPS,
                model=1 if mesh is None else mesh[1],
                init=str(d / f"{name}{tag}-init.npz"),
                out=str(d / f"{name}{tag}-{where}.npz"), **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each arch at one process and on each mesh of MESHES, flux-dev at 3
    heads at one process and on (1, 2), and each one's micro-batch
    gradients at (2, 2) in both packages, all started at once."""
    d = tmp_path_factory.mktemp("tpd")
    groups, refs = {}, ([], [])
    cases = [(name, "", {}, MESHES) for name in ARCHS]
    cases.append((HEADS3[0], "-h3", HEADS3[1], ((1, 2),)))
    for i, (name, tag, over, meshes) in enumerate(cases):
        write_init(d / f"{name}{tag}-init.npz", name, over)
        extra = {"over": over} if over else {}
        groups.setdefault((0, "one"), []).append(
            job(d, name, None, tag, **extra))
        for mesh in meshes:
            groups.setdefault((mesh[0] * mesh[1], mesh[1]), []).append(
                job(d, name, mesh, tag, **extra))
        grads = job(d, name, (2, 2), tag, grads=True, **extra)
        grads["out"] = grads["out"].replace(".npz", "-grads.npz")
        groups.setdefault((4, "grads"), []).append(grads)
        refs[i % 2].append(dict(grads, out=grads["out"].replace("-grads",
                                                                 "-ref")))
    started = [_start(ranks, WORKER, jobs) for (ranks, _), jobs in
               groups.items()]
    started += [_start(0, REFERENCE, ref, {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
        for ref in refs]
    _check(_join(*started, limit=LIMIT_S))
    return d


CASES = [(a, "", m) for a in ARCHS for m in MESHES] + [
    (HEADS3[0], "-h3", (1, 2))]


@pytest.mark.parametrize("arch,tag,mesh", CASES, ids=[
    f"{a}{t}-{m[0]}x{m[1]}" for a, t, m in CASES])
def test_ranks_match_one_process(runs, arch, tag, mesh):
    one = np.load(runs / f"{arch}{tag}-one.npz")
    got = np.load(runs / f"{arch}{tag}-{mesh[0]}x{mesh[1]}.npz")
    assert int(got["opt/step"]) == int(one["opt/step"]) == STEPS
    assert _max_rel(got["hist/loss"], one["hist/loss"]) <= 1e-5
    assert _rel(got, one, "params") <= 1e-5
    assert _rel(got, one, "opt/mu") <= 1e-4
    # The params moved: the comparison is not of the init with itself.
    init = np.load(runs / f"{arch}{tag}-init.npz")
    assert _rel(one, _Tree({f"params/{k}": init[k] for k in init.files}),
                "params") > 1e-3


class _Tree:
    """A dict of arrays read as a loaded npz is (``files``, ``[key]``)."""

    def __init__(self, arrays):
        self.arrays = arrays
        self.files = list(arrays)

    def __getitem__(self, key):
        return self.arrays[key]


FALLBACK = [("vdit-paper", "", (1, 4)), (HEADS3[0], "-h3", (1, 2))]


@pytest.mark.parametrize("arch,tag,mesh", FALLBACK, ids=[
    f"{a}{t}-{m[0]}x{m[1]}" for a, t, m in FALLBACK])
def test_undivided_heads_take_the_query_row_region(runs, arch, tag, mesh):
    """Where the heads do not divide the model axis every attention is a
    query-row region (its output rows joined over the sequence): the
    vdit's one a layer, the mmdit's one a double and a single block, in
    each of 3 steps; where they divide, none is."""
    got = np.load(runs / f"{arch}{tag}-{mesh[0]}x{mesh[1]}.npz")
    cfg = _jarch(arch, HEADS3[1] if tag else None).model
    layers = (cfg.num_layers if arch == "vdit-paper" else
              cfg.n_double_blocks + cfg.n_single_blocks)
    assert int(got["seq_joins"]) == STEPS * layers
    divided = np.load(runs / f"{arch}-{'1x2' if tag else '2x2'}.npz")
    assert int(divided["seq_joins"]) == 0


REF_CASES = [(a, "") for a in ARCHS] + [(HEADS3[0], "-h3")]


@pytest.mark.parametrize("arch,tag", REF_CASES,
                         ids=[f"{a}{t}" for a, t in REF_CASES])
def test_two_by_two_matches_the_reference(runs, arch, tag):
    want = np.load(runs / f"{arch}{tag}-2x2-ref.npz")
    got = np.load(runs / f"{arch}{tag}-2x2-grads.npz")
    w = float(want["loss"])
    assert abs(float(got["loss"]) - w) <= 1e-5 * abs(w)
    assert _rel(got, want, "grads") <= 1e-5


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("data,model", [(2, 2), (1, 4), (2, 4)])
def test_pieces_are_the_reference_specs(name, data, model):
    """``distributed.fsdp``'s 2-D pieces of each tree on rank 0 of a fake
    (data, model) group are the reference's ``param_rules`` specs of its
    logical axes (a dim on an axis that does not divide it whole, the
    smoke vit-l16's 10 classes at model 4 among them), layers stacked;
    a block is whole over the batch group only: its ``model`` pieces
    stay."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.models.params import init_model, jax_tree

    jarch = _jarch(name)
    jmesh = SimpleNamespace(axis_names=("data", "model"),
                            shape={"data": data, "model": model})
    rules = j_sh.param_rules(jmesh)
    axes = _flat(logical_axes(model_fns(jarch)), leaf=tuple)
    whole = _flat(jax.eval_shape(lambda: init_params(
        model_fns(jarch), jax.random.PRNGKey(0))), leaf=lambda a: a.shape)
    mdl = init_model(get_smoke_config(name).model, seed=0, device="cpu")
    for p in mdl.parameters():
        p.requires_grad_(True)
    with dryrun._fake_ranks(data * model, model) as mesh:
        from repro_torch.distributed.fsdp import ParamShards

        sh = ParamShards(mdl, mesh)
        assert sh.group is mesh.batch_group()
        index = {id(p): i for i, p in enumerate(sh.params)}
        pieces = _flat(jax_tree(mdl, lambda p: sh.local[index[id(p)]]))
        blocks = _flat(jax_tree(mdl, lambda p: torch.empty(
            sh.block_shapes[index[id(p)]] if sh.n > 1 else
            sh.local[index[id(p)]].shape)))
    assert sorted(pieces) == sorted(axes)
    on_model = 0
    for k, ax in axes.items():
        spec = tuple(j_sh.spec_from_axes(ax, rules, whole[k], jmesh))
        spec += (None,) * (len(ax) - len(spec))
        want = tuple(n // j_sh.axis_size(jmesh, e)
                     for n, e in zip(whole[k], spec))
        assert pieces[k].shape == want, (k, spec)
        assert blocks[k].shape == tuple(
            n // model if e == "model" else n
            for n, e in zip(whole[k], spec)), k
        on_model += "model" in spec
    assert on_model > 0



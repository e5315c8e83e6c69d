"""Expert parallelism (``models.moe``'s ``impl="ep"``) against the JAX
package's on the CPU.

A subprocess runs the reference's ``moe_ffn(impl="ep")`` jitted on a
(data 2, model 4) mesh of 8 virtual devices (JAX fixes its device count
at start), and the reference's slot-order lines on its own router's
choices; the port runs the same params and tokens on a 2x4 mesh of CPU
shards.  At a capacity that drops slots and at one that does not: every
(token shard, model shard)'s kept-slot mask bit-equal, the outputs
within 1e-5 and the aux within 1e-6.  Dense against EP within 1e-4, as
``tests/test_distributed.py`` has it; the LM's serving steps under a
dispatch mesh take the EP path."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config.base import MoEConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.sharding import ShardCtx, decode_act_rules  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

torch.set_num_threads(2)

D = 16
# The reference test's MoE on 128 tokens (64 a token shard) at a capacity
# without drops (16) and one that drops (0.5: 8 slots an expert, the
# floor, against 16 routed on average).
CAPACITY = {"no-drop": 16.0, "drops": 0.5}

_JAX_EP = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.config.base import MoEConfig
from repro.distributed.sharding import ShardCtx, train_act_rules
from repro.models import moe as moe_lib
from repro.models.params import init_params

out = {}
mesh = jax.make_mesh((2, 4), ("data", "model"))
ctx = ShardCtx(mesh, train_act_rules(mesh))
x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 64, 16)))
out["x"] = x
for name, cf in (("no-drop", 16.0), ("drops", 0.5)):
    cfg = MoEConfig(num_experts=8, top_k=2, expert_ffw_dim=32,
                    capacity_factor=cf)
    params = init_params(moe_lib.moe_defs(16, cfg), jax.random.PRNGKey(0))
    for k, v in params.items():
        out[f"params/{k}"] = np.asarray(v)
    ep, aux = jax.jit(lambda p, x: moe_lib.moe_ffn(
        p, x, cfg, ctx=ctx, impl="ep"))(params, x)
    dense, _ = moe_lib.moe_ffn(params, x, cfg, impl="dense")
    out[f"{name}/ep"], out[f"{name}/aux"] = np.asarray(ep), np.asarray(aux)
    out[f"{name}/dense"] = np.asarray(dense)
    # The reference's slot order (moe.py _local_dispatch_ffn) on its own
    # router's choices, for each (token shard, model shard).
    x_flat = x.reshape(128, 16)
    E_loc, N_loc = 2, 64
    C = max(int(N_loc * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 8)
    for t in range(2):
        idx, _, _ = moe_lib._router({"router": params["router"]},
                                    jnp.asarray(x_flat[t * 64:(t + 1) * 64]),
                                    cfg)
        out[f"{name}/topk/{t}"] = np.asarray(idx)
        for m in range(4):
            e_lo = m * E_loc
            slot_e = idx.reshape(-1)
            mine = jnp.logical_and(slot_e >= e_lo, slot_e < e_lo + E_loc)
            local_e = jnp.where(mine, slot_e - e_lo, E_loc)
            onehot = jax.nn.one_hot(local_e, E_loc + 1, dtype=jnp.int32)
            pos = jnp.cumsum(onehot, axis=0) - 1
            pos = jnp.sum(pos * onehot, axis=1)
            out[f"{name}/keep/{t}/{m}"] = np.asarray(
                jnp.logical_and(mine, pos < C))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    path = tmp_path_factory.mktemp("ep") / "jax.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="src",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", _JAX_EP, str(path)],
                         env=env, cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return np.load(path)


def _mesh(d, m):
    return Mesh(("data", "model"), (d, m), (torch.device("cpu"),) * (d * m))


def _port(want, cf):
    cfg = MoEConfig(num_experts=8, top_k=2, expert_ffw_dim=32,
                    capacity_factor=cf)
    p = moe.MoE(D, cfg)
    with torch.no_grad():
        for k in ("router", "wi_gate", "wi_up", "wo"):
            getattr(p, k).copy_(torch.from_numpy(want[f"params/{k}"]))
    return cfg, p


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_ep_matches_the_jax_ep(jax_ep, case):
    cfg, p = _port(jax_ep, CAPACITY[case])
    mesh = _mesh(2, 4)
    x = torch.from_numpy(jax_ep["x"])
    ctx = ShardCtx(mesh, decode_act_rules(mesh))
    with torch.no_grad():
        out, aux = moe.moe_ffn(p, x, cfg, ctx=ctx, impl="ep")
    np.testing.assert_allclose(out.numpy(), jax_ep[f"{case}/ep"], rtol=0,
                               atol=1e-5)
    assert abs(float(aux) - float(jax_ep[f"{case}/aux"])) <= 1e-6
    C = max(int(64 * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 8)
    kept = 0
    for t in range(2):
        idx, _, _ = moe._router(p, x.reshape(128, D)[t * 64:(t + 1) * 64], cfg)
        np.testing.assert_array_equal(idx.numpy(), jax_ep[f"{case}/topk/{t}"])
        for m in range(4):
            keep, _, _ = moe.dispatch_slots(idx, m * 2, 2, C)
            np.testing.assert_array_equal(keep.numpy(),
                                          jax_ep[f"{case}/keep/{t}/{m}"])
            kept += int(keep.sum())
    routed = 128 * cfg.top_k
    assert (kept == routed) == (case == "no-drop"), (kept, routed)


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_dense_against_ep(jax_ep, case):
    """Without drops EP is the dense path within 1e-4 (the reference's
    test); with drops the dropped slots are what differs."""
    cfg, p = _port(jax_ep, CAPACITY[case])
    x = torch.from_numpy(jax_ep["x"])
    mesh = _mesh(2, 4)
    with torch.no_grad():
        dense, _ = moe.moe_ffn(p, x, cfg, impl="dense")
        ep, _ = moe.moe_ffn(p, x, cfg, ctx=ShardCtx(mesh), impl="auto")
    np.testing.assert_allclose(dense.numpy(), jax_ep[f"{case}/dense"],
                               rtol=0, atol=1e-5)
    err = float(torch.max(torch.abs(dense - ep)))
    if case == "no-drop":
        assert err < 1e-4, err
    else:
        assert err > 1e-3, err


def test_auto_keys_on_the_mesh():
    """``auto`` is dense without a mesh or when the model axis does not
    divide the experts, EP otherwise (the reference's choice)."""
    cfg = MoEConfig(num_experts=6, top_k=2, expert_ffw_dim=8)
    assert not moe._use_ep("auto", cfg, ShardCtx())
    assert not moe._use_ep("auto", cfg, ShardCtx(_mesh(1, 4)))
    assert moe._use_ep("auto", cfg, ShardCtx(_mesh(1, 2)))
    assert not moe._use_ep("dense", cfg, ShardCtx(_mesh(1, 2)))


def test_lm_serve_steps_on_a_mesh_run_ep():
    """The smoke qwen2-moe's prefill and a decode step through
    ``lm_serve_steps(mesh=1x4)``: every MoE layer takes the EP path
    (``shard_map`` on 4 shards), and with a capacity that drops nothing
    the logits are the unsharded run's within the LM bf16 bar."""
    from repro_torch.launch.workloads import lm_serve_steps
    from repro_torch.models.params import init_model

    arch = get_smoke_config("qwen2-moe-a2.7b")
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, moe=dataclasses.replace(arch.model.moe,
                                            capacity_factor=8.0)))
    model = init_model(arch.model, seed=0, device="cpu", zero_init=False)
    shape = dataclasses.replace(arch.shape("decode_32k"), seq_len=64)
    tokens = torch.randint(0, arch.model.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    calls = []
    orig = moe._ep_moe
    moe._ep_moe = lambda *a: calls.append(1) or orig(*a)
    try:
        outs = {}
        for name, mesh in (("dense", None), ("ep", _mesh(1, 4))):
            prefill, decode = lm_serve_steps(arch, shape, model, mesh=mesh)
            logits, cache = prefill(tokens)
            nxt, _ = decode(logits.argmax(-1), cache, 16)
            outs[name] = torch.cat([logits, nxt], 1).float()
    finally:
        moe._ep_moe = orig
    assert len(calls) == 2 * arch.model.num_layers
    rel = float(torch.linalg.vector_norm(outs["ep"] - outs["dense"])
                / torch.linalg.vector_norm(outs["dense"]))
    assert rel <= 3e-2, rel


_JAX_DRIFT = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.distributed.sharding import NULL_CTX, ShardCtx, decode_act_rules
from repro.models import transformer_lm as lm
from repro.models.params import init_params

arch = get_smoke_config("qwen2-moe-a2.7b")
cfg = dataclasses.replace(arch.model, num_layers=int(sys.argv[2]),
                          moe=dataclasses.replace(arch.model.moe,
                                                  capacity_factor=16.0))
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 4),
                         ("data", "model"))
params = init_params(lm.lm_defs(cfg), jax.random.PRNGKey(0))
tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 64))
out = {"tokens": tokens}
for dt in ("bfloat16", "float32"):
    for name, ctx in (("ep", ShardCtx(mesh, decode_act_rules(mesh))),
                      ("dense", NULL_CTX)):
        out[f"{dt}/{name}"] = np.asarray(jax.jit(lambda p, t: lm.lm_apply(
            p, t, cfg, ctx=ctx, compute_dtype=getattr(jnp, dt))[0])(
                params, jnp.asarray(tokens)), np.float32)
flat, _ = jax.tree_util.tree_flatten_with_path(params)
for path, leaf in flat:
    out["params/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


def test_bf16_ep_drifts_from_dense_in_both_packages(tmp_path):
    """The smoke qwen2-moe at 4 layers, capacity 16 (nothing drops), EP on
    a 1x4 mesh against the dense path, logits' relative L2: in float32
    within 1e-5 in both packages; in bfloat16 the reference's own EP
    is above the LM bar of 3e-2 from its dense path (its slot-by-slot
    bf16 combine and the dense path's gate-weighted sum round
    differently, and the difference grows with depth), and the port's,
    on the same params and tokens, is of the same order (within 3x)."""
    from repro_torch.launch.mesh import Mesh as TMesh
    from repro_torch.models.params import params_from_numpy
    from repro_torch.models import transformer_lm as t_lm

    layers = 4
    path = tmp_path / "drift.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="src",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _JAX_DRIFT, str(path),
                          str(layers)], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    got = np.load(path)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    tree = {}
    for k in got.files:
        if k.startswith("params/"):
            node, *keys = tree, *k.split("/")[1:]
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = got[k]
    arch = get_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(arch.model, num_layers=layers,
                              moe=dataclasses.replace(arch.model.moe,
                                                      capacity_factor=16.0))
    model = params_from_numpy(tree, cfg, device="cpu")
    mesh = TMesh(("data", "model"), (1, 4), (torch.device("cpu"),) * 4)
    tokens = torch.from_numpy(got["tokens"])
    port = {}
    for dt in ("bfloat16", "float32"):
        for name, ctx in (("ep", ShardCtx(mesh, decode_act_rules(mesh))),
                          ("dense", None)):
            kw = {"ctx": ctx} if ctx is not None else {}
            with torch.no_grad():
                port[f"{dt}/{name}"] = t_lm.lm_apply(
                    model, tokens, cfg, compute_dtype=getattr(torch, dt),
                    **kw)[0].float().numpy()
    ref = {dt: rel(got[f"{dt}/ep"], got[f"{dt}/dense"])
           for dt in ("bfloat16", "float32")}
    mine = {dt: rel(port[f"{dt}/ep"], port[f"{dt}/dense"])
            for dt in ("bfloat16", "float32")}
    assert ref["float32"] <= 1e-5 and mine["float32"] <= 1e-5, (ref, mine)
    assert ref["bfloat16"] > 3e-2, ref
    assert ref["bfloat16"] / 3 <= mine["bfloat16"] <= 3 * ref["bfloat16"], \
        (ref, mine)


# The reference's EP under ``jax.value_and_grad`` on a (data 2, model 2)
# mesh of 4 of the 8 virtual devices: loss = sum(out * w) + aux, the
# gradients of the params and the tokens, and the kept-slot lines of each
# (token shard, model shard) at 4 experts a shard.
_JAX_EP_GRAD = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.config.base import MoEConfig
from repro.distributed.sharding import ShardCtx, train_act_rules
from repro.models import moe as moe_lib
from repro.models.params import init_params

out = {}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
ctx = ShardCtx(mesh, train_act_rules(mesh))
x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 64, 16)))
w = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (2, 64, 16)))
out["x"], out["w"] = x, w
for name, cf in (("no-drop", 16.0), ("drops", 0.5)):
    cfg = MoEConfig(num_experts=8, top_k=2, expert_ffw_dim=32,
                    capacity_factor=cf)
    params = init_params(moe_lib.moe_defs(16, cfg), jax.random.PRNGKey(0))
    for k, v in params.items():
        out[f"params/{k}"] = np.asarray(v)

    def loss(p, x):
        y, aux = moe_lib.moe_ffn(p, x, cfg, ctx=ctx, impl="ep")
        return jnp.sum(y * w) + aux

    val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        params, x)
    out[f"{name}/loss"], out[f"{name}/grad/x"] = np.asarray(val), np.asarray(gx)
    for k, v in gp.items():
        out[f"{name}/grad/{k}"] = np.asarray(v)
    C = max(int(64 * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 8)
    for t in range(2):
        idx, _, _ = moe_lib._router({"router": params["router"]},
                                    jnp.asarray(x[t]), cfg)
        for m in range(2):
            slot_e = idx.reshape(-1)
            mine = jnp.logical_and(slot_e >= 4 * m, slot_e < 4 * m + 4)
            local_e = jnp.where(mine, slot_e - 4 * m, 4)
            onehot = jax.nn.one_hot(local_e, 5, dtype=jnp.int32)
            pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=1)
            out[f"{name}/keep/{t}/{m}"] = np.asarray(
                jnp.logical_and(mine, pos < C))
np.savez(sys.argv[1], **out)
"""

# One gloo rank of a (data 2, model 2) rank mesh: its token row, its 4
# experts, the EP region under autograd (tp.enter, moe_ffn, tp.leave) and
# loss = sum(out * w) + aux / 2 (the batch axes' mean of the aux); writes
# its gradients and kept-slot lines.
_PORT_EP_GRAD = r"""
import sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.config.base import MoEConfig
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.launch.mesh import init_distributed, make_rank_mesh
from repro_torch.models import moe

torch.set_num_threads(1)
init_distributed(device="cpu")
mesh = make_rank_mesh(model_axis=2, device="cpu")
t, m, tp = mesh.batch_index(), mesh.model_index(), mesh.tensor_parallel()
want = np.load(sys.argv[1])
out = {}
for name, cf in (("no-drop", 16.0), ("drops", 0.5)):
    cfg = MoEConfig(num_experts=8, top_k=2, expert_ffw_dim=32,
                    capacity_factor=cf)
    p = moe.MoE(16, cfg)
    for k in ("router", "wi_gate", "wi_up", "wo"):
        whole = torch.from_numpy(want[f"params/{k}"])
        getattr(p, k).data = (whole if k == "router" else
                              whole[4 * m:4 * m + 4]).clone()
    for q in p.parameters():
        q.requires_grad_(True)
    x = torch.from_numpy(want["x"][t:t + 1]).requires_grad_(True)
    part, aux = moe.moe_ffn(p, tp.enter(x), cfg, ctx=ShardCtx(tp=tp),
                            impl="ep")
    loss = torch.sum(tp.leave(part) * torch.from_numpy(want["w"][t:t + 1])) \
        + aux / 2
    loss.backward()
    out[f"{name}/loss"] = loss.detach().numpy()
    out[f"{name}/grad/x"] = x.grad.numpy()
    for k in ("router", "wi_gate", "wi_up", "wo"):
        out[f"{name}/grad/{k}"] = getattr(p, k).grad.numpy()
    idx, _, _ = moe._router(p, torch.from_numpy(want["x"][t]), cfg)
    C = max(int(64 * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 8)
    keep, _, _ = moe.dispatch_slots(idx, 4 * m, 4, C)
    out[f"{name}/keep"] = keep.numpy()
    if name == "no-drop":
        # impl="dense" under the model group: whole expert weights, the
        # group's first rank contributing the output.
        q = moe.MoE(16, cfg)
        for k in ("router", "wi_gate", "wi_up", "wo"):
            getattr(q, k).data = torch.from_numpy(want[f"params/{k}"]).clone()
            getattr(q, k).requires_grad_(True)
        x = torch.from_numpy(want["x"][t:t + 1]).requires_grad_(True)
        part, aux = moe.moe_ffn(q, tp.enter(x), cfg, ctx=ShardCtx(tp=tp),
                                impl="dense")
        loss = torch.sum(tp.leave(part) *
                         torch.from_numpy(want["w"][t:t + 1])) + aux / 2
        loss.backward()
        out["dense/grad/x"] = x.grad.numpy()
        for k in ("router", "wi_gate", "wi_up", "wo"):
            out[f"dense/grad/{k}"] = getattr(q, k).grad.numpy()
np.savez(sys.argv[2] + f"-{t}-{m}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ep_grads(tmp_path_factory):
    """(the reference's gradients, each rank's of the port's (2, 2) run)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_distributed import _env, _free_port, _join

    d = tmp_path_factory.mktemp("epgrad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="src",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", _JAX_EP_GRAD,
                          str(d / "jax.npz")], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PORT_EP_GRAD, str(d / "jax.npz"),
         str(d / "port")], cwd=root, env=_env(r, 4, port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    for rc, text in _join(procs)[0]:
        assert rc == 0, text[-3000:]
    ranks = {(t, m): np.load(d / f"port-{t}-{m}.npz")
             for t in range(2) for m in range(2)}
    return np.load(d / "jax.npz"), ranks


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_ep_gradients_match_jax_value_and_grad(ep_grads, case):
    """EP under autograd on a (2, 2) rank mesh against ``jax.value_and_grad``
    of the reference's ``moe_ffn(impl="ep")``: the summed loss, the
    gradients of the router, the experts (each model rank's 4) and the
    tokens within 1e-5 relative; the kept-slot masks bit-equal; slots
    dropped at the capacity that drops and none at the other."""
    want, ranks = ep_grads
    loss = sum(float(r[f"{case}/loss"]) for (t, m), r in ranks.items()
               if m == 0)
    assert abs(loss - float(want[f"{case}/loss"])) <= \
        1e-5 * abs(float(want[f"{case}/loss"]))

    def close(got, ref):
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert err <= 1e-5, err

    close(sum(ranks[(t, 0)][f"{case}/grad/router"] for t in range(2)),
          want[f"{case}/grad/router"])
    for k in ("wi_gate", "wi_up", "wo"):
        got = np.concatenate([sum(ranks[(t, m)][f"{case}/grad/{k}"]
                                  for t in range(2)) for m in range(2)])
        close(got, want[f"{case}/grad/{k}"])
    for m in range(2):
        close(np.concatenate([ranks[(t, m)][f"{case}/grad/x"]
                              for t in range(2)]), want[f"{case}/grad/x"])
    kept = 0
    for (t, m), r in ranks.items():
        np.testing.assert_array_equal(r[f"{case}/keep"],
                                      want[f"{case}/keep/{t}/{m}"])
        kept += int(r[f"{case}/keep"].sum())
    assert (kept == 2 * 64 * 2) == (case == "no-drop"), kept
    if case == "no-drop":
        # The dense MoE under the model group (whole experts, the first
        # rank's output) has EP's gradients where EP drops nothing.
        for k in ("router", "wi_gate", "wi_up", "wo"):
            close(sum(ranks[(t, 0)][f"dense/grad/{k}"] for t in range(2)),
                  want[f"{case}/grad/{k}"])
        for m in range(2):
            close(np.concatenate([ranks[(t, m)]["dense/grad/x"]
                                  for t in range(2)]), want[f"{case}/grad/x"])

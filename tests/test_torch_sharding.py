"""The port's rule tables, straggler policy, int8 compression and elastic
resharding against the JAX package's ``repro.distributed`` on the CPU.

- Every parameter's logical axes (``models.params.logical_axes``: the
  reference's ``logical_axes(defs)`` without the stacked ``layers`` dim)
  and its ``spec_from_axes`` spec on the production meshes (data 16 x
  model 16, and pod 2 x data 16 x model 16; the reference's functions
  read only ``axis_names`` and ``shape``), for all eleven configs, with
  and without FSDP; the activation rule tables.
- ``StragglerPolicy`` decisions on Hypothesis-drawn step times.
- ``quantize_int8`` / ``compress_grads`` bit-equal to the jitted JAX
  functions on float32 inputs, ties at .5 included; compressed training
  converges as the reference's own test has it.
- ``reshard_state`` over a dispatch mesh: 1 -> 4 -> 2 bit-equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.config.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.distributed import collectives as j_coll  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.distributed.straggler import StragglerPolicy as JPolicy  # noqa: E402
from repro.launch.workloads import model_fns  # noqa: E402
from repro.models.params import abstract_params  # noqa: E402
from repro.models.params import logical_axes as j_logical_axes  # noqa: E402
from repro_torch.config.base import TrainConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import collectives, sharding, spmd  # noqa: E402
from repro_torch.distributed.elastic import reshard_state  # noqa: E402
from repro_torch.distributed.straggler import StragglerPolicy  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.params import logical_axes  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402


class FakeMesh:
    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


MESHES = {"data16xmodel16": FakeMesh(("data", "model"), (16, 16)),
          "pod2xdata16xmodel16": FakeMesh(("pod", "data", "model"),
                                          (2, 16, 16))}


def _pairs(ref, port, path=()):
    """(path, reference leaf, port leaf) of two trees of the same
    structure (a JAX tree's dicts come back key-sorted), by key."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), path
        for k in port:
            yield from _pairs(ref[k], port[k], path + (k,))
    elif isinstance(port, list):
        assert len(port) == len(ref), path
        for i, v in enumerate(port):
            yield from _pairs(ref[i], v, path + (i,))
    else:
        yield path, ref, port


def _ref(name, smoke):
    arch = (j_smoke if smoke else j_get)(name)
    defs = model_fns(arch)
    axes = j_logical_axes(defs)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    abstract_params(defs))
    return axes, shapes


def _port_shapes(cfg):
    from repro_torch.models.params import _family

    _, specs = _family(cfg)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return tuple(t[0])

    return walk(specs)


def _tuple(spec):
    """A spec's entries, a one-axis tuple as its axis (JAX's
    ``PartitionSpec`` writes ("data",) as "data"; the two shard alike)."""
    out = []
    for e in spec:
        if isinstance(e, (list, tuple)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


CONFIGS = [(n, s) for n in ALL_ARCHS for s in (False, True)]
IDS = [f"{n}{'-smoke' if s else ''}" for n, s in CONFIGS]


@pytest.mark.parametrize("name,smoke", CONFIGS, ids=IDS)
def test_logical_axes_equal_the_reference(name, smoke):
    """Every leaf's logical axes equal the reference's, the stacked
    subtrees' leading ``layers`` dim dropped (the port keeps a list of
    layers); the shapes agree the same way."""
    ref_axes, ref_shapes = _ref(name, smoke)
    cfg = (get_smoke_config if smoke else get_config)(name).model
    port_axes = logical_axes(cfg)
    port_shapes = _port_shapes(cfg)
    n = 0
    for path, (ra, rs), (pa, ps) in _pairs(
            _zip(ref_axes, ref_shapes), _zip(port_axes, port_shapes)):
        if ra and ra[0] == "layers":
            ra, rs = ra[1:], rs[1:]
        assert (ra, tuple(rs)) == (pa, ps), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(
        ref_shapes, is_leaf=lambda x: isinstance(x, tuple)))


def _zip(axes, shapes):
    """One tree of (axes, shape) leaves."""
    if isinstance(axes, dict):
        return {k: _zip(v, shapes[k]) for k, v in axes.items()}
    if isinstance(axes, list):
        return [_zip(v, shapes[i]) for i, v in enumerate(axes)]
    return (axes, shapes)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no-fsdp"])
@pytest.mark.parametrize("name,smoke", CONFIGS, ids=IDS)
def test_param_specs_equal_the_reference(name, smoke, fsdp, mesh):
    """``spec_from_axes`` of every leaf under ``param_rules(mesh, fsdp)``
    equals the reference's spec of the stacked leaf with its replicated
    ``layers`` entry dropped; ``param_sharding_tree`` agrees leaf by
    leaf."""
    m = MESHES[mesh]
    ref_axes, ref_shapes = _ref(name, smoke)
    cfg = (get_smoke_config if smoke else get_config)(name).model
    port_axes, port_shapes = logical_axes(cfg), _port_shapes(cfg)
    rules_j, rules_t = j_sh.param_rules(m, fsdp=fsdp), \
        sharding.param_rules(m, fsdp=fsdp)
    assert rules_t == rules_j
    tree = sharding.param_sharding_tree(port_axes, m, rules_t, port_shapes)
    port = _zip(port_axes, port_shapes)
    for path, (ra, rs), (pa, ps) in _pairs(_zip(ref_axes, ref_shapes), port):
        want = _tuple(j_sh.spec_from_axes(ra, rules_j, tuple(rs), m))
        if ra and ra[0] == "layers":
            want = want[1:]
        got = sharding.spec_from_axes(pa, rules_t, ps, m)
        assert isinstance(got, spmd.P)
        assert _tuple(got) == want, path
        node = tree
        for k in path:
            node = node[k]
        assert node == got, path


@pytest.mark.parametrize("mesh", sorted(MESHES) + ["none"])
def test_activation_rules_equal_the_reference(mesh):
    m = MESHES.get(mesh)
    assert sharding.train_act_rules(m) == j_sh.train_act_rules(m)
    assert sharding.train_act_rules(m, True) == j_sh.train_act_rules(m, True)
    for lc in (False, True):
        for rh in (False, True):
            assert sharding.decode_act_rules(m, lc, rh) == \
                j_sh.decode_act_rules(m, lc, rh)
    if m is not None:
        for b in (1, 2, 3, 16, 32, 48, 64):
            assert sharding.seqpar_act_rules(m, b) == \
                j_sh.seqpar_act_rules(m, b)
    assert sharding.batch_axes(m) == j_sh.batch_axes(m)


def test_spec_from_axes_edge_cases_equal_the_reference():
    """The reference's own cases: an indivisible dim falls back to
    replicated, and a mesh axis is used once."""
    m = MESHES["data16xmodel16"]
    rules = {"kv": "model", "embed": ("data",)}
    for axes, shape in ((("embed", "kv"), (64, 8)), (("embed", "kv"),
                                                     (64, 32)),
                        (("kv", "embed"), (16, 48))):
        assert _tuple(sharding.spec_from_axes(axes, rules, shape, m)) == \
            _tuple(j_sh.spec_from_axes(axes, rules, shape, m))
    rules = {"a": "model", "b": "model"}
    assert _tuple(sharding.spec_from_axes(("a", "b"), rules)) == \
        _tuple(j_sh.spec_from_axes(("a", "b"), rules)) == ("model",)


def test_shard_ctx_constrains_nothing():
    m = MESHES["data16xmodel16"]
    ctx = sharding.ShardCtx(m, sharding.train_act_rules(m))
    x = torch.randn(32, 8, 64)
    assert ctx.c(x, ("batch", "seq", "embed")) is x
    assert sharding.NULL_CTX.c(x, ("batch",)) is x
    assert sharding.NULL_CTX.mesh is None and sharding.NULL_CTX.batch_group is None


# --- straggler policy -----------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(st.floats(0.01, 100.0), min_size=4, max_size=4),
                min_size=1, max_size=12),
       st.floats(1.1, 4.0), st.floats(0.0, 0.6), st.integers(1, 5))
def test_straggler_decisions_equal_the_reference(steps, factor, frac, evict):
    """A run of steps' host times through both policies: the skipped and
    evicted hosts of every step and the rescale factors are equal."""
    t = StragglerPolicy(deadline_factor=factor, max_skip_fraction=frac,
                        evict_after=evict)
    j = JPolicy(deadline_factor=factor, max_skip_fraction=frac,
                evict_after=evict)
    for times in steps:
        got, want = t.decide(times), j.decide(times)
        assert got == want
        assert StragglerPolicy.gradient_rescale(len(times), got[0]) == \
            JPolicy.gradient_rescale(len(times), want[0])


# --- int8 compression -----------------------------------------------------------

# amax 0.9921875 = 127 / 128 makes the scale exactly 2^-7 (the product
# with float32(1/127) rounds to it), so (k + 0.5) / 128 lands on .5.
TIE_AMAX = np.float32(0.9921875)


def _cases():
    rng = np.random.default_rng(0)
    out = []
    for i in range(60):
        n = int(rng.integers(1, 40)) if i % 2 else int(rng.integers(40, 3000))
        g = (rng.standard_normal(n) * 10 ** rng.uniform(-8, 3)).astype(
            np.float32)
        e = (rng.standard_normal(n) * 10 ** rng.uniform(-9, 0)).astype(
            np.float32)
        out.append((g, e))
    ties = ((rng.integers(-127, 127, 500) + 0.5) / 128).astype(np.float32)
    ties[0] = TIE_AMAX
    out += [(ties, np.zeros_like(ties)), (np.zeros(7, np.float32),
                                          np.zeros(7, np.float32)),
            (np.array([3.0], np.float32), np.array([1e-3], np.float32))]
    return out


def test_quantize_int8_bit_equal_to_jitted_jax():
    jq = jax.jit(j_coll.quantize_int8)
    for g, _ in _cases():
        q, s = collectives.quantize_int8(torch.from_numpy(g))
        jq_, js = jq(g)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
        assert s.dtype == torch.float32
        assert s.item() == float(js)
        np.testing.assert_array_equal(
            collectives.dequantize_int8(q, s).numpy(),
            np.asarray(j_coll.dequantize_int8(jq_, js)))


def test_ties_round_half_to_even():
    g = np.array([TIE_AMAX, 0.5 / 128, 1.5 / 128, 2.5 / 128, -2.5 / 128],
                 np.float32)
    q, s = collectives.quantize_int8(torch.from_numpy(g))
    assert s.item() == 2.0 ** -7
    assert q.tolist() == [127, 0, 2, 2, -2]


def test_compress_grads_bit_equal_to_jitted_jax():
    """Decompressed gradients and residuals, several leaves at once (one
    of one element: XLA rounds its residual twice, the others once)."""
    cases = _cases()
    grads = [g for g, _ in cases]
    errs = [e for _, e in cases]
    jout, jst = jax.jit(j_coll.compress_grads)(
        grads, j_coll.CompressionState(error=errs))
    tout, tst = collectives.compress_grads(
        [torch.from_numpy(g) for g in grads],
        collectives.CompressionState([torch.from_numpy(e) for e in errs]))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tst.error, jst.error):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert collectives.compressed_bytes([torch.from_numpy(g) for g in grads]) \
        == int(j_coll.compressed_bytes(grads))


def test_sharded_scale_is_the_whole_tensors():
    """With a ``reduce_max`` standing in for the all-reduce over ranks,
    each half of a tensor quantizes to the whole tensor's codes."""
    g = torch.from_numpy(_cases()[3][0])
    whole_q, whole_s = collectives.quantize_int8(g)
    halves = g.chunk(2)
    amax = torch.amax(torch.abs(g))
    parts = [collectives.quantize_int8(h, lambda x: torch.maximum(x, amax))
             for h in halves]
    assert all(s.item() == whole_s.item() for _, s in parts)
    assert torch.equal(torch.cat([q for q, _ in parts]), whole_q)


def test_error_feedback_preserves_the_sum():
    """The reference's property: the sum of what was sent tracks the sum
    of the gradients within a few steps' quantization error."""
    rng = np.random.default_rng(1)
    grads = [torch.from_numpy((rng.standard_normal(64) * 0.01).astype(
        np.float32)) for _ in range(30)]
    state = collectives.compression_init([grads[0]])
    sent = torch.zeros(64)
    for g in grads:
        (s,), state = collectives.compress_grads([g], state)
        sent += s
    resid = float(torch.max(torch.abs(sum(grads) - sent)))
    assert resid < 5 * float(torch.max(torch.abs(grads[0]))) / 127


def test_compressed_training_converges():
    """The reference's test through the port's ``make_train_step``: linear
    regression with int8 + error feedback reaches 100x below its start
    and within 10x of the exact run."""
    g = torch.Generator().manual_seed(0)
    X = torch.randn(128, 8, generator=g)
    y = X @ torch.arange(1.0, 9.0)

    class Lin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(8))

    def loss_fn(model, batch, gen):
        return torch.mean((batch["x"] @ model.w - batch["y"]) ** 2), {}

    def run(compress):
        cfg = dataclasses.replace(TrainConfig(), learning_rate=0.05,
                                  warmup_steps=1, total_steps=200,
                                  weight_decay=0.0, schedule="constant",
                                  grad_compression=compress)
        step = train_loop.make_train_step(loss_fn, cfg)
        state = train_loop.train_state_init(Lin(), cfg)
        for _ in range(150):
            state, m = step(state, {"x": X, "y": y}, 0)
        return float(m["loss"])

    exact, compressed = run(False), run(True)
    start = float(torch.mean(y ** 2))
    assert compressed < start * 1e-2
    assert compressed < max(exact, 1e-3) * 10
    # the reference's config and the port's agree on the defaults used
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())


# --- elastic --------------------------------------------------------------------


def _cpu_mesh(d, m):
    return Mesh(("data", "model"), (d, m), (torch.device("cpu"),) * (d * m))


def _gather(pieces, mesh, axes, shapes):
    """Whole tensors from every coordinate's pieces, each written into its
    slice of its rule-table spec."""
    out = {}
    rules = sharding.param_rules(mesh)
    for k, shape in shapes.items():
        out[k] = torch.empty(shape)
        spec = sharding.spec_from_axes(axes[k], rules, shape, mesh)
        for c, tree in zip(mesh.coords(), pieces):
            out[k][spmd._slices(mesh, spec, shape, c)] = tree[k]
    return out


def test_reshard_state_one_to_four_to_two():
    """The reference's elastic test on dispatch meshes of the CPU: whole
    arrays cut by their rule-table specs onto a (2, 2) mesh, gathered,
    cut onto (1, 2) and gathered come back bit-equal; each piece has the
    shape its spec gives."""
    w = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    state = {"w": w, "b": torch.randn(3, 8)}
    axes = {"w": ("embed", "mlp"), "b": (None, "embed")}
    shapes = {"w": (8, 16), "b": (3, 8)}
    m4, m2 = _cpu_mesh(2, 2), _cpu_mesh(1, 2)
    p4 = [reshard_state(state, axes, m4, coords=c) for c in m4.coords()]
    assert p4[0]["w"].shape == (4, 8) and p4[0]["b"].shape == (3, 4)
    back = _gather(p4, m4, axes, shapes)
    p2 = [reshard_state(back, axes, m2, coords=c) for c in m2.coords()]
    assert p2[1]["w"].shape == (8, 8)
    again = _gather(p2, m2, axes, shapes)
    assert torch.equal(again["w"], w)
    assert torch.equal(again["b"], state["b"])


def test_psum_and_pmean_over_a_tuple_of_axes():
    """``pmean`` over (data, model) of a 2x2 CPU mesh is the mean of the
    four shards' values on every shard."""
    m = _cpu_mesh(2, 2)
    x = torch.arange(4.0).reshape(2, 2)

    def body(piece):
        return (spmd.psum(piece, ("data", "model")),
                spmd.pmean(piece, ("data", "model")))

    s, mean = spmd.shard_map(body, m, in_specs=(spmd.P("data", "model"),),
                             out_specs=(spmd.P("data", "model"),
                                        spmd.P("data", "model")))(x)
    assert torch.equal(s, torch.full((2, 2), 6.0))
    assert torch.equal(mean, torch.full((2, 2), 1.5))


@pytest.mark.parametrize("name,smoke", CONFIGS, ids=IDS)
def test_arch_config_fields_equal_the_reference(name, smoke):
    """The ``ArchConfig`` fields of every config, the decode sharding
    variants (``decode_replicate_heads``, ``decode_no_fsdp``) included:
    the same names, and equal values for the plain ones (the nested
    configs have tests of their own)."""
    port = (get_smoke_config if smoke else get_config)(name)
    ref = (j_smoke if smoke else j_get)(name)
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for f in names:
        v = getattr(port, f)
        if isinstance(v, (str, bool, int, float)):
            assert v == getattr(ref, f), f
    assert port.decode_replicate_heads is False and port.decode_no_fsdp is False

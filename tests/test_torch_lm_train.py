"""The port's LM training path against the JAX package on the CPU:
``lm_loss`` and its gradients against ``jax.value_and_grad`` of the
reference's ``lm_loss`` on the same params (the JAX init, passed across
through numpy) and tokens, for a dense config (gemma3-4b's smoke: sliding
windows, qk-norm, an untied head) and an MoE one (qwen2-moe's: the
router's aux loss and its gradient); the sequence-chunked cross entropy
with both packages' ``_CE_CELL_BUDGET`` / ``_CE_CHUNK`` patched; remat
(``full``, ``dots``) against none; three ``make_train_step`` steps
against the reference's; and the grouped AdamW update against the
whole-tree one.

Bars (PR 28's): float32 compute, loss within 1e-5 and the gradient tree
within 1e-4 relative L2; bfloat16 compute (two implementations that
round at other places), the tree within 5e-2 and the loss within 2e-2."""

import collections
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import transformer_lm as j_lm  # noqa: E402
from repro.training import train_loop as j_loop  # noqa: E402
from repro_torch.config.base import TrainConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import workloads  # noqa: E402
from repro_torch.models import transformer_lm as lm  # noqa: E402
from repro_torch.models.params import init_model, jax_tree  # noqa: E402
from repro_torch.training import optimizer, train_loop  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

torch.set_num_threads(2)

DENSE, MOE = "gemma3-4b", "qwen2-moe-a2.7b"
B, S = 2, 16


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_np_tree(v) for v in t]
    return np.array(t.detach().numpy(), copy=True)


def _setup(name):
    """(port arch, JAX arch, port model with every leaf random and
    requiring grad, the same params as a JAX tree)."""
    arch, jarch = get_smoke_config(name), j_smoke(name)
    model = init_model(arch.model, seed=0, device="cpu", zero_init=False)
    for p in model.parameters():
        p.requires_grad_(True)
    params = jax.tree_util.tree_map(jnp.asarray, _np_tree(jax_tree(model)))
    return arch, jarch, model, params


@functools.lru_cache(maxsize=None)
def _j_value_and_grad(name, dtype):
    """The reference's jitted ``value_and_grad(lm_loss)`` of a smoke
    config: (params, tokens, targets) -> ((loss, metrics), grads)."""
    cfg, dt = j_smoke(name).model, getattr(jnp, dtype)
    return jax.jit(jax.value_and_grad(
        lambda p, tok, tgt: j_lm.lm_loss(p, tok, tgt, cfg, compute_dtype=dt),
        has_aux=True))


def _tokens(seed, vocab, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _tree_rel(got, want):
    g = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(got)]
    w = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(want)]
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(g, w))
    return (num / sum(float(np.sum(b ** 2)) for b in w)) ** 0.5


def _port_loss(model, arch, tok, tgt, dt, **kw):
    return lm.lm_loss(model, torch.from_numpy(tok).long(),
                      torch.from_numpy(tgt).long(), arch.model,
                      compute_dtype=dt, **kw)


def port_and_jax(name, dtype, seed=1, vg=None):
    """The port's loss, metrics and gradient tree, and the reference's,
    on one token draw."""
    arch, jarch, model, params = _setup(name)
    tok, tgt = _tokens(seed, arch.model.vocab_size)
    loss, m = _port_loss(model, arch, tok, tgt, getattr(torch, dtype))
    loss.backward()
    m = {k: v.detach() for k, v in m.items()}
    vg = vg or _j_value_and_grad(name, dtype)
    (j_loss, j_m), j_grads = vg(params, tok, tgt)
    grads = _np_tree(jax_tree(model, lambda p: p.grad))
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(j_grads)
    assert all(np.any(g != 0) for g in jax.tree_util.tree_leaves(grads))
    return (loss.detach(), m, grads), (j_loss, j_m, j_grads)


def check_against_jax(name, dtype, vg=None):
    (loss, m, grads), (j_loss, j_m, j_grads) = port_and_jax(name, dtype,
                                                            vg=vg)
    bar = 1e-5 if dtype == "float32" else 2e-2
    for k, got, want in (("loss", loss, j_loss), ("nll", m["nll"], j_m["nll"]),
                         ("aux", m["aux"], j_m["aux"])):
        assert _rel(float(got), float(want)) <= bar or \
            float(got) == float(want) == 0.0, k
    assert _tree_rel(grads, j_grads) <= (1e-4 if dtype == "float32"
                                         else 5e-2)
    return m, grads, j_grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [DENSE, MOE])
def test_loss_and_grads_match_jax(name, dtype):
    m, grads, j_grads = check_against_jax(name, dtype)
    if name == MOE:
        # the router's aux loss flows into the loss and into the router
        assert float(m["aux"]) > 0
        router = grads["blocks"]["moe"]["router"]
        assert np.all(np.abs(router).sum(axis=(1, 2)) > 0)
        if dtype == "float32":
            assert _rel(router, j_grads["blocks"]["moe"]["router"]) <= 1e-4
    else:
        assert float(m["aux"]) == 0.0


def test_moe_bfloat16_grads_agree_as_the_jax_packages_own():
    """The MoE's bf16 gradient over more draws: bf16 rounding flips
    top-k choices of the router in either package (the JAX package's
    own bf16 gradient lies 1.6-7.9% from its f32 one over six draws), so
    beside the one-draw bar the mean gap between the two packages' bf16
    gradients over three draws must be within 1.25x the mean gap between
    the JAX package's bf16 and f32 gradients."""
    gaps, own = [], []
    for seed in (1, 2, 3):
        (_, _, g16), (_, _, j16) = port_and_jax(MOE, "bfloat16", seed)
        _, (_, _, j32) = port_and_jax(MOE, "float32", seed)
        gaps.append(_tree_rel(g16, j16))
        own.append(_tree_rel(j16, j32))
    assert np.mean(gaps) <= 1.25 * np.mean(own), (gaps, own)


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_the_chunked_cross_entropy_matches_jax(name, monkeypatch):
    """Both packages forced onto the chunked path: 8-token chunks of a
    16-token sequence."""
    for mod in (lm, j_lm):
        monkeypatch.setattr(mod, "_CE_CELL_BUDGET", 0)
        monkeypatch.setattr(mod, "_CE_CHUNK", 8)
    chunks = []
    orig = lm._chunk_ce

    def spy(h, t, head):
        chunks.append(tuple(h.shape))
        return orig(h, t, head)

    monkeypatch.setattr(lm, "_chunk_ce", spy)
    cfg = j_smoke(name).model
    check_against_jax(name, "float32", vg=jax.jit(jax.value_and_grad(
        lambda p, tok, tgt: j_lm.lm_loss(p, tok, tgt, cfg,
                                         compute_dtype=jnp.float32),
        has_aux=True)))
    # two chunks in the forward, each recomputed once in the backward
    assert chunks == [(B, 8, 64)] * 4


@torch.no_grad()
def test_the_chunked_and_whole_cross_entropy_agree(monkeypatch):
    arch, _, model, _ = _setup(DENSE)
    tok, tgt = _tokens(2, arch.model.vocab_size)
    whole, _ = _port_loss(model, arch, tok, tgt, torch.float32)
    for budget, chunk in ((0, 8), (0, 5)):  # 5 does not divide 16: whole
        monkeypatch.setattr(lm, "_CE_CELL_BUDGET", budget)
        monkeypatch.setattr(lm, "_CE_CHUNK", chunk)
        got, _ = _port_loss(model, arch, tok, tgt, torch.float32)
        assert abs(float(got) - float(whole)) <= 1e-6 * float(whole)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_remat_policies_give_equal_grads(name):
    """No remat, ``full`` and ``dots``: bit-equal gradients.  In the
    backward pass ``full`` recomputes the weight products (2-D ``mm``)
    and the batched ones (``bmm``); ``dots`` only the batched ones."""
    arch, _, model, _ = _setup(name)
    tok, tgt = _tokens(3, arch.model.vocab_size)
    grads, ops = {}, {}
    for mode in ("off", "full", "dots"):
        model.zero_grad(set_to_none=True)
        loss, _ = _port_loss(model, arch, tok, tgt, torch.float32,
                             remat=mode != "off",
                             remat_policy="full" if mode == "off" else mode)
        with _OpCount() as count:
            loss.backward()
        grads[mode] = [p.grad.clone() for p in model.parameters()]
        ops[mode] = {k: count.n[getattr(torch.ops.aten, k).default]
                     for k in ("mm", "bmm")}
    for mode in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(grads[mode],
                                                     grads["off"])), mode
    assert ops["dots"]["mm"] == ops["off"]["mm"] < ops["full"]["mm"]
    assert ops["dots"]["bmm"] == ops["full"]["bmm"] > ops["off"]["bmm"]


def test_an_unknown_remat_policy_raises():
    arch, _, model, _ = _setup(DENSE)
    tok, tgt = _tokens(4, arch.model.vocab_size)
    with pytest.raises(ValueError, match="remat policy 'offload'"):
        _port_loss(model, arch, tok, tgt, torch.float32,
                   remat_policy="offload")


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_the_reference(accum):
    """Three AdamW steps of the smoke gemma3-4b in float32 compute
    through ``workloads.train_loss_fn``: metrics, params and moments
    against the reference's ``make_train_step(lm_loss ...)``."""
    arch, jarch, model, params = _setup(DENSE)
    kw = dict(learning_rate=1e-3, warmup_steps=1, grad_accum=accum,
              compute_dtype="float32")
    tcfg = dataclasses.replace(arch.train, **kw)
    jcfg = dataclasses.replace(jarch.train, **kw)
    arch = dataclasses.replace(arch, train=tcfg)

    def j_fn(p, b, rng):
        return j_lm.lm_loss(p, b["tokens"], b["targets"], jarch.model,
                            compute_dtype=jnp.float32, remat=jcfg.remat)

    j_step = jax.jit(j_loop.make_train_step(j_fn, jcfg))
    t_step = train_loop.make_train_step(workloads.train_loss_fn(arch), tcfg)
    j_state = j_loop.train_state_init(params, jcfg)
    t_state = train_loop.train_state_init(model, tcfg)
    for i in range(3):
        tok, tgt = _tokens(10 + i, arch.model.vocab_size)
        nb = {"tokens": tok, "targets": tgt}
        j_state, j_m = j_step(j_state, jax.tree_util.tree_map(
            jnp.asarray, nb), jax.random.PRNGKey(i))
        t_state, t_m = t_step(t_state, {k: torch.from_numpy(v).long()
                                        for k, v in nb.items()}, 0)
        for k in ("loss", "nll", "grad_norm", "lr"):
            assert _rel(float(t_m[k]), float(j_m[k])) <= 1e-5, (i, k)
    tree = train_loop.state_tree(t_state)
    assert int(tree["opt"]["step"]) == int(j_state.opt.step) == 3
    assert _tree_rel(_np_tree(tree["params"]), j_state.params) <= 1e-5
    assert _tree_rel(_np_tree(tree["opt"]["mu"]), j_state.opt.mu) <= 1e-4
    assert _tree_rel(_np_tree(tree["opt"]["nu"]), j_state.opt.nu) <= 1e-4


def test_grouped_adamw_is_bit_equal_to_the_whole_tree(monkeypatch):
    """Groups of 7 elements (leaves split across groups, groups across
    leaves, a bfloat16 parameter) against one group holding the whole
    tree: three steps, params and moments bit for bit; each gradient
    is released once its leaf is updated."""
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    gen = torch.Generator().manual_seed(0)
    shapes = [(5, 3), (2,), (4, 4, 2), (1,), (9,)]
    base = [torch.randn(s, generator=gen) for s in shapes]
    base[3] = base[3].to(torch.bfloat16)
    grads = [[(3 * torch.randn(s, generator=gen)).to(p.dtype)
              for s, p in zip(shapes, base)] for _ in range(3)]
    out = {}
    for size in (7, 1 << 28):
        monkeypatch.setattr(optimizer, "_GROUP_ELEMS", size)
        params = [p.clone().requires_grad_(True) for p in base]
        state = optimizer.adamw_init(params)
        for step in range(3):
            g = [x.clone() for x in grads[step]]
            for p, x in zip(params, g):
                p.grad = x
            state, m = optimizer.adamw_update(g, state, params, cfg)
            assert g == [None] * len(g)
            assert all(p.grad is None for p in params)
        out[size] = (params, state, m)
    (p7, s7, m7), (pw, sw, mw) = out[7], out[1 << 28]
    for a, b in zip(p7 + s7.mu + s7.nu, pw + sw.mu + sw.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(m7["grad_norm"], mw["grad_norm"])
    monkeypatch.setattr(optimizer, "_GROUP_ELEMS", 7)
    sizes = [int(np.prod(s)) for s in shapes]
    groups = list(optimizer._groups(sizes))
    assert [sum(b - a for _, a, b in g) for g in groups] == \
        [7] * (sum(sizes) // 7) + [sum(sizes) % 7]
    covered = collections.defaultdict(list)
    for g in groups:
        for i, a, b in g:
            covered[i].append((a, b))
    for i, n in enumerate(sizes):
        ends = [a for a, _ in covered[i]] + [n]
        assert ends[0] == 0 and all(
            b == ends[j + 1] for j, (_, b) in enumerate(covered[i]))

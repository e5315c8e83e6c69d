"""The port's LM training launcher on the CPU: ``token_batch``'s
structure and its id distribution against the JAX package's, the
launcher's smoke run on gemma3-4b's ``train_4k`` with checkpoints, a
resume that ends bit-equal to the uninterrupted run, and LM training
checkpoints read both ways between the packages.

The launcher runs the smoke config's ``train_4k`` cut to ``SEQ`` tokens
(:func:`short_smoke`): 4096 tokens at batch 4 take about 26 s a step on
two CPU threads."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data import synthetic as j_synth  # noqa: E402
from repro.training import train_loop as j_loop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import DataSpec, token_batch  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models.params import init_model, jax_tree  # noqa: E402
from repro_torch.training.train_loop import state_tree  # noqa: E402
from test_torch_serve import ROOT, _port_files  # noqa: E402

torch.set_num_threads(2)

SEQ = 64
LM_SMOKE = ["--arch", "gemma3-4b", "--shape", "train_4k", "--smoke",
            "--device", "cpu", "--batch-override", "4"]


def short_smoke(monkeypatch, seq=SEQ):
    """Make the launcher's smoke configs' ``train_4k`` ``seq`` tokens."""
    orig = train_lib.get_smoke_config

    def smoke(name):
        arch = orig(name)
        return dataclasses.replace(arch, shapes=tuple(
            dataclasses.replace(s, seq_len=seq) if s.name == "train_4k"
            else s for s in arch.shapes))

    monkeypatch.setattr(train_lib, "get_smoke_config", smoke)


def _ids(b):
    """The ids a batch was cut from: the tokens and the last target."""
    return torch.cat([b["tokens"][:, :-1], b["targets"][:, -2:-1]], 1)


def test_token_batch_structure():
    b = token_batch(DataSpec(seed=3), 5, 4, 64, 256)
    tok, tgt = b["tokens"], b["targets"]
    assert tok.shape == tgt.shape == (4, 64)
    assert tok.dtype == tgt.dtype == torch.int64
    assert torch.equal(tgt[:, :-2], tok[:, 1:-1])  # shifted by one
    assert not tok[:, -1].any() and not tgt[:, -1].any()  # the 0 column
    ids = _ids(b)
    assert int(ids.min()) >= 0 and int(ids.max()) < 256
    odd = (torch.arange(64) // 8) % 2 == 1
    assert torch.equal(ids[:, odd], ids[:, torch.arange(64)[odd] - 8])
    assert not torch.equal(ids[:, 8:16], ids[:, 16:24])  # even: fresh
    again = token_batch(DataSpec(seed=3), 5, 4, 64, 256)
    assert all(torch.equal(b[k], again[k]) for k in b)
    for spec, index in ((DataSpec(seed=4), 5), (DataSpec(seed=3), 6),
                        (DataSpec(seed=3, shard=1), 5)):
        assert not torch.equal(token_batch(spec, index, 4, 64, 256)["tokens"],
                               tok)


def test_token_ids_follow_the_jax_distribution():
    """Ids in octave bins [0, 1), [1, 2), [2, 4), ..., [128, 256) from
    16 x 1024 draws of each package within five standard errors of each
    other (the repeated windows halve the independent draws)."""
    V, B, S = 256, 16, 1024
    port = _ids(token_batch(DataSpec(seed=0), 0, B, S, V)).numpy()
    ref = np.asarray(j_synth.token_batch(j_synth.DataSpec(seed=0), 0, B, S,
                                         V)["tokens"])[:, :-1]
    edges = [0, 1] + [2 ** k for k in range(1, 9)]
    p = np.histogram(port, edges)[0] / port.size
    j = np.histogram(ref, edges)[0] / ref.size
    n = port.size / 2
    se = np.sqrt(2 * j * (1 - j) / n)
    assert np.all(np.abs(p - j) <= 5 * se + 1e-12), (p, j)
    # the analytic bin masses of ids floor(V ** u - 1)
    want = np.diff(np.log(np.asarray(edges) + 1.0)) / np.log(V)
    assert np.all(np.abs(p - want) <= 5 * np.sqrt(want * (1 - want) / n))


def _params(state):
    return {n: p.detach().clone() for n, p in
            state.params.named_parameters()}


def test_smoke_run_with_checkpoints(tmp_path, monkeypatch):
    short_smoke(monkeypatch)
    state, history = train_lib.main(LM_SMOKE + [
        "--steps", "2", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert state.opt.step == 2
    assert [h["step"] for h in history] == [0, 1]
    for h in history:
        assert np.isfinite(h["loss"]) and h["grad_norm"] > 0
        assert h["aux"] == 0.0 and h["loss"] == h["nll"]
        # near-uniform logits at init: the nll is about ln 256
        assert abs(h["nll"] - np.log(256)) < 0.1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002"]


def test_resume_ends_bit_equal_to_the_uninterrupted_run(tmp_path,
                                                        monkeypatch):
    short_smoke(monkeypatch)
    argv = LM_SMOKE + ["--ckpt-every", "2", "--ckpt-dir"]
    full, _ = train_lib.main(argv + [str(tmp_path / "a"), "--steps", "4"])
    cut, _ = train_lib.main(argv + [str(tmp_path / "b"), "--steps", "2"])
    assert cut.opt.step == 2
    resumed, history = train_lib.main(argv + [str(tmp_path / "b"),
                                              "--steps", "4"])
    assert [h["step"] for h in history] == [3]  # steps 2 and 3 ran
    want, got = _params(full), _params(resumed)
    assert all(torch.equal(got[n], want[n]) for n in want)
    for a, b in zip(resumed.opt.mu + resumed.opt.nu,
                    full.opt.mu + full.opt.nu):
        assert torch.equal(a, b)


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_np_tree(v) for v in t]
    return np.array(t.detach().numpy(), copy=True)


def _jax_state(seed, step):
    """A JAX ``TrainState`` of the smoke gemma3-4b with random params and
    moments and ``step``."""
    jarch = j_smoke("gemma3-4b")
    model = init_model(get_smoke_config("gemma3-4b").model, seed=seed,
                       device="cpu", zero_init=False)
    params = jax.tree_util.tree_map(jnp.asarray, _np_tree(jax_tree(model)))
    state = j_loop.train_state_init(params, jarch.train)
    rng = np.random.default_rng(seed)

    def moment(a):
        return jnp.asarray(rng.random(a.shape, np.float32))

    opt = state.opt._replace(step=jnp.asarray(step, jnp.int32),
                             mu=jax.tree_util.tree_map(moment, params),
                             nu=jax.tree_util.tree_map(moment, params))
    return state._replace(opt=opt)


def test_the_jax_package_restores_the_launchers_lm_checkpoint(tmp_path,
                                                              monkeypatch):
    short_smoke(monkeypatch)
    state, _ = train_lib.main(LM_SMOKE + ["--steps", "2", "--ckpt-every",
                                          "2", "--ckpt-dir", str(tmp_path)])
    step, restored, _ = JCheckpointer(str(tmp_path)).restore_latest(
        _jax_state(1, 0))
    assert step == 2 and int(restored.opt.step) == 2
    want = state_tree(state)
    for tree, got in (("params", restored.params), ("mu", restored.opt.mu),
                      ("nu", restored.opt.nu)):
        w = want[tree] if tree == "params" else want["opt"][tree]
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(w)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_the_launcher_resumes_from_a_jax_lm_checkpoint(tmp_path,
                                                       monkeypatch):
    """A JAX-written state at step 3 is what ``main`` resumes into (no
    step left to run at ``--steps 3``), leaf for leaf."""
    short_smoke(monkeypatch)
    jstate = _jax_state(2, 3)
    ck = JCheckpointer(str(tmp_path), async_save=False)
    ck.save(3, jstate)
    state, history = train_lib.main(LM_SMOKE + ["--steps", "3", "--ckpt-dir",
                                                str(tmp_path)])
    assert history == [] and state.opt.step == 3
    got = state_tree(state)
    for tree, want in (("params", jstate.params), ("mu", jstate.opt.mu),
                       ("nu", jstate.opt.nu)):
        g = got[tree] if tree == "params" else got["opt"][tree]
        assert jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda x: 0, g)) == \
            jax.tree_util.tree_structure(jax.tree_util.tree_map(
                lambda x: 0, want))
        for a, b in zip(jax.tree_util.tree_leaves(g),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lm_training_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lib.main(["--arch", "gemma3-4b", "--shape", "train_4k",
                        "--smoke", "--steps", "1"])


def test_the_import_scan_covers_the_lm_training_code():
    scanned = set(_port_files())
    for rel in ("src/repro_torch/data/synthetic.py",
                "src/repro_torch/models/transformer_lm.py",
                "src/repro_torch/models/moe.py",
                "src/repro_torch/models/common.py",
                "src/repro_torch/launch/workloads.py",
                "src/repro_torch/launch/train.py",
                "src/repro_torch/training/optimizer.py", "chip_smoke.py"):
        assert ROOT / rel in scanned, rel

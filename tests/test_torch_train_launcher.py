"""The port's training launcher on the CPU: the JAX launcher's flags and
defaults, a smoke run with checkpoints, auto-resume that ends bit-equal
to the uninterrupted run, checkpoints that the JAX package restores into
its own ``TrainState``, the refusal without a card, and one LM step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.launch.workloads import model_fns  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.training import train_loop as j_loop  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.training.train_loop import state_tree  # noqa: E402
from test_torch_lm_train_launcher import LM_SMOKE, short_smoke  # noqa: E402
from test_torch_serve import _launcher_parser  # noqa: E402

torch.set_num_threads(2)

SMOKE = ["--arch", "dit-b2", "--shape", "train_256", "--smoke",
         "--batch-override", "4", "--device", "cpu"]


def _params(state):
    return {n: p.detach().clone() for n, p in
            state.params.named_parameters()}


def test_flag_defaults_equal_the_jax_launchers(monkeypatch):
    def defaults(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}

    port = defaults(_launcher_parser(train_lib.main, monkeypatch))
    ref = defaults(_launcher_parser(j_train.main, monkeypatch))
    assert set(ref) <= set(port)
    assert {k: port[k] for k in ref} == ref
    assert port["device"] == "cuda"


def test_smoke_run_with_checkpoints(tmp_path):
    state, history = train_lib.main(SMOKE + [
        "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert state.opt.step == 4
    assert [h["step"] for h in history] == [0, 3]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in history)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000004"]


def test_resume_ends_bit_equal_to_the_uninterrupted_run(tmp_path):
    full, _ = train_lib.main(SMOKE + ["--steps", "4", "--ckpt-every", "2",
                                      "--ckpt-dir", str(tmp_path / "a")])
    cut, _ = train_lib.main(SMOKE + ["--steps", "2", "--ckpt-every", "2",
                                     "--ckpt-dir", str(tmp_path / "b")])
    assert cut.opt.step == 2
    resumed, history = train_lib.main(SMOKE + [
        "--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
        str(tmp_path / "b")])
    assert [h["step"] for h in history] == [3]  # steps 2 and 3 ran
    want, got = _params(full), _params(resumed)
    assert all(torch.equal(got[n], want[n]) for n in want)
    for a, b in zip(resumed.opt.mu + resumed.opt.nu,
                    full.opt.mu + full.opt.nu):
        assert torch.equal(a, b)


def test_the_jax_package_restores_the_launchers_checkpoint(tmp_path):
    state, _ = train_lib.main(SMOKE + ["--steps", "2", "--ckpt-every", "2",
                                       "--ckpt-dir", str(tmp_path)])
    jarch = j_smoke("dit-b2")
    template = j_loop.train_state_init(
        init_params(model_fns(jarch), jax.random.PRNGKey(0)), jarch.train)
    step, restored, _ = JCheckpointer(str(tmp_path)).restore_latest(template)
    assert step == 2 and int(restored.opt.step) == 2
    want = state_tree(state)
    np.testing.assert_array_equal(
        np.asarray(restored.params["blocks"]["attn"]["wq"]),
        want["params"]["blocks"]["attn"]["wq"].numpy())
    np.testing.assert_array_equal(
        np.asarray(restored.opt.nu["final"]["w"]),
        want["opt"]["nu"]["final"]["w"].numpy())


def test_main_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lib.main(["--arch", "dit-b2", "--shape", "train_256",
                        "--smoke", "--steps", "1"])


def test_lm_training_is_the_next_slice(monkeypatch):
    """The LM family, once refused here as the next slice, trains: one
    step of the smoke gemma3-4b (``train_4k`` cut to 64 tokens)."""
    short_smoke(monkeypatch)
    state, history = train_lib.main(LM_SMOKE + ["--steps", "1"])
    assert state.opt.step == 1 and [h["step"] for h in history] == [0]
    assert np.isfinite(history[0]["nll"]) and history[0]["grad_norm"] > 0

"""The port's checkpointer against the JAX package's: one on-disk format
read both ways, bit for bit; the crash-consistency rules (a corrupt
newest blob falls back, ``.tmp`` directories are invisible), retention,
and an async save that must not see a later in-place update."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"blocks": {"w": rng.standard_normal((3, 4, 5)).astype(
                np.float32)},
                       "b": rng.standard_normal(5).astype(np.float32),
                       "levels": [rng.standard_normal(2).astype(np.float32),
                                  rng.integers(0, 9, 3).astype(np.int32)]},
            "opt": {"step": np.asarray(7, np.int32)}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_same(got, want):
    """``got`` a path -> array map (a restore's), ``want`` a tree."""
    want = _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_restores_a_jax_checkpoint_bit_equal(tmp_path):
    tree = _tree(0)
    j = JCheckpointer(str(tmp_path), async_save=False)
    j.save(5, jax.tree_util.tree_map(jnp.asarray, tree))
    port = Checkpointer(str(tmp_path))
    assert port.list_steps() == [5] and port.validate(5)
    step, arrays, extra = port.restore_latest()
    assert step == 5 and extra == {}
    _assert_same(arrays, tree)
    assert "params/levels/1" in arrays and "opt/step" in arrays


def test_jax_restores_a_port_checkpoint_bit_equal(tmp_path):
    tree = _tree(1)
    torch_tree = {"params": {"blocks": {"w": torch.from_numpy(
                      tree["params"]["blocks"]["w"])},
                  "b": torch.from_numpy(tree["params"]["b"]),
                  "levels": [torch.from_numpy(a)
                             for a in tree["params"]["levels"]]},
                  "opt": {"step": tree["opt"]["step"]}}
    port = Checkpointer(str(tmp_path), async_save=True)
    port.save(3, torch_tree, extra={"note": "port"})
    port.wait()
    j = JCheckpointer(str(tmp_path))
    step, state, extra = j.restore_latest(tree)
    assert step == 3 and extra == {"note": "port"}
    _assert_same(_flat(state), tree)


def test_truncated_newest_blob_falls_back(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _tree(1))
    ck.save(2, _tree(2))
    blob = tmp_path / "step_00000002" / "arrays.npz"
    blob.write_bytes(blob.read_bytes()[:100])
    assert not ck.validate(2) and ck.validate(1)
    step, arrays, _ = ck.restore_latest()
    assert step == 1
    _assert_same(arrays, _tree(1))


def test_tmp_directories_are_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _tree(1))
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "step_00000009.tmp" / "MANIFEST.json").write_text("{}")
    assert ck.list_steps() == [1]
    assert ck.restore_latest()[0] == 1


def test_keep_retains_the_newest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    assert ck.list_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


def test_async_save_keeps_the_weights_it_was_given(tmp_path, monkeypatch):
    """The writer thread is held back until after an in-place update of
    the saved tensor: the checkpoint still holds the old values."""
    import threading

    ck = Checkpointer(str(tmp_path), async_save=True)
    gate = threading.Event()
    write = ck._write

    def held(*args):
        assert gate.wait(10)
        write(*args)

    monkeypatch.setattr(ck, "_write", held)
    w = torch.zeros(4, 3)
    ck.save(1, {"w": w})
    w.add_(1.0)  # the next step's in-place update
    gate.set()
    ck.wait()
    _, arrays, _ = ck.restore_latest()
    np.testing.assert_array_equal(arrays["w"], np.zeros((4, 3), np.float32))


def test_restore_checks_shapes_and_leaves(tmp_path):
    """A restored map goes into a train state leaf by leaf: a missing
    leaf or one of another shape is refused, not copied in."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_model
    from repro_torch.training import train_loop

    cfg = get_smoke_config("dit-b2").model
    state = train_loop.train_state_init(
        init_model(cfg, seed=0, device="cpu"), TrainConfig())
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, train_loop.state_tree(state))
    arrays, _ = ck.restore(1)
    assert train_loop.load_state_tree(state, arrays).opt.step == 0
    key = next(k for k in arrays if k.startswith("opt/mu/"))
    with pytest.raises(ValueError, match="shape"):
        train_loop.load_state_tree(
            state, {**arrays, key: np.zeros((1,) + arrays[key].shape,
                                            arrays[key].dtype)})
    with pytest.raises(KeyError, match="missing leaf"):
        train_loop.load_state_tree(
            state, {k: v for k, v in arrays.items() if k != key})

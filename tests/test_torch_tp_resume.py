"""A training checkpoint resumed at another (data, model) rank-mesh
shape, on the CPU over gloo: the LM (2, 2) -> (4, 1) -> one process,
the DiT (1, 2) -> (2, 1) -> one process, each restored state bit-equal
to the checkpoint it read (the reference's npz and manifest, whole
arrays), and the resumed run's nll (the DiT's loss) the uninterrupted
run's within 1e-5.  The workers are ``tests/test_torch_tp.py``'s and
``tests/test_torch_tp_diffusion.py``'s."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import _join  # noqa: E402
from test_torch_tp import (BATCH, LIMIT_S, SEQ, WORKER, _check,  # noqa: E402
                           _max_rel, _start)


def test_resume_across_mesh_shapes_is_bit_equal(tmp_path):
    """A step at (2, 2), a second at (4, 1), a third at one process, from
    one checkpoint directory: each restored state equals, bit for bit,
    the checkpoint it was restored from; the third step's nll is the
    uninterrupted run's within 1e-5."""
    from repro_torch.checkpoint.checkpointer import Checkpointer

    ck = tmp_path / "ck"
    base = dict(arch="qwen2-moe-a2.7b", sp=False, seq=SEQ, batch=BATCH,
                ckpt=str(ck))
    whole = _start(0, WORKER, [dict(base, model=1, steps=3, ckpt="",
                                    out=str(tmp_path / "whole.npz"))])
    saved = {}
    for ranks, model, steps in ((4, 2, 1), (4, 1, 2), (0, 1, 3)):
        job = dict(base, model=model, steps=steps,
                   restored=str(tmp_path / f"restored-{steps}.npz"),
                   out=str(tmp_path / f"out-{steps}.npz"))
        if steps > 1:
            found, arrays, _ = Checkpointer(str(ck)).restore_latest()
            assert found == steps - 1
            saved[steps] = {k: np.array(v) for k, v in arrays.items()}
        _check(_join(_start(ranks, WORKER, [job]), limit=LIMIT_S))
    _check(_join(whole, limit=LIMIT_S))
    for steps, arrays in saved.items():
        got = np.load(tmp_path / f"restored-{steps}.npz")
        assert sorted(got.files) == sorted(arrays)
        for k, v in arrays.items():
            assert np.array_equal(got[k], v), (steps, k)
    last = np.load(tmp_path / "out-3.npz")["hist/nll"][-1]
    assert _max_rel(last, np.load(tmp_path / "whole.npz")["hist/nll"][-1]) \
        <= 1e-5


def test_dit_resume_across_mesh_shapes_is_bit_equal(tmp_path):
    """The smoke dit-xl2 (``tests/test_torch_tp_diffusion.py``'s worker
    and init): a step at (1, 2), a second at (2, 1), a third at one
    process, from one checkpoint directory: each restored state equals,
    bit for bit, the checkpoint it was restored from; the third step's
    loss is the uninterrupted run's within 1e-5."""
    from test_torch_tp_diffusion import WORKER as DIFFUSION, job, write_init

    from repro_torch.checkpoint.checkpointer import Checkpointer

    ck = tmp_path / "ck"
    write_init(tmp_path / "dit-xl2-init.npz", "dit-xl2")
    whole = _start(0, DIFFUSION, [dict(job(tmp_path, "dit-xl2", None),
                                       out=str(tmp_path / "whole.npz"))])
    saved = {}
    for ranks, model, steps in ((2, 2, 1), (2, 1, 2), (0, 1, 3)):
        run = dict(job(tmp_path, "dit-xl2", None), model=model, steps=steps,
                   ckpt=str(ck), out=str(tmp_path / f"out-{steps}.npz"),
                   restored=str(tmp_path / f"restored-{steps}.npz"))
        if steps > 1:
            found, arrays, _ = Checkpointer(str(ck)).restore_latest()
            assert found == steps - 1
            saved[steps] = {k: np.array(v) for k, v in arrays.items()}
        _check(_join(_start(ranks, DIFFUSION, [run]), limit=LIMIT_S))
    _check(_join(whole, limit=LIMIT_S))
    for steps, arrays in saved.items():
        got = np.load(tmp_path / f"restored-{steps}.npz")
        assert sorted(got.files) == sorted(arrays)
        for k, v in arrays.items():
            assert np.array_equal(got[k], v), (steps, k)
    last = np.load(tmp_path / "out-3.npz")["hist/loss"][-1]
    assert _max_rel(last, np.load(tmp_path / "whole.npz")["hist/loss"][-1]) \
        <= 1e-5

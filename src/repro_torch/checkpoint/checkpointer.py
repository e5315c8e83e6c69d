"""Checkpointing: atomic, CRC-validated, async, retention-managed, in the
JAX package's on-disk format (``checkpoint/checkpointer.py``), so either
package reads the other's checkpoints.

Layout per step::

    <dir>/step_00000400/
        arrays.npz      # one entry per tree leaf, keyed by its path
        MANIFEST.json   # crc32 of the blob and of each leaf; written LAST

A leaf's key is its path joined by ``/``: dict keys, NamedTuple field
names and list indices, as ``jax.tree_util`` names them.  The manifest is
the commit record: a step directory is written as ``<name>.tmp`` and
renamed once complete, and a checkpoint without a valid manifest is
invisible to :meth:`Checkpointer.restore_latest`, which also skips a
step whose blob fails its CRC.  ``save`` copies every leaf to host
memory before it returns, so an async write (a background thread) never
reads a tensor that the next training step updates in place.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.logging import get_logger
from repro_torch.utils.pytree import tree_items

log = get_logger("ckpt")
_MANIFEST = "MANIFEST.json"
_ARRAYS = "arrays.npz"


def _host_copy(x) -> np.ndarray:
    """A host copy of a leaf that shares no memory with it."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def flatten_state(state) -> Dict[str, np.ndarray]:
    """path -> host copy of every leaf (tensors, numpy arrays, numbers)."""
    return {"/".join(str(p) for p in path): _host_copy(x)
            for path, x in tree_items(state)}


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state, *, extra: Optional[dict] = None):
        arrays = flatten_state(state)  # host copy, before any writer runs
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_async, args=(step, arrays, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, extra or {})

    def wait(self):
        """Join the writer thread; re-raise a failure it met."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_async(self, step, arrays, extra):
        try:
            self._write(step, arrays, extra)
        except Exception as e:  # reported by the next wait()
            log.exception("checkpoint step %d failed", step)
            self._error = e

    def _write(self, step: int, arrays: Dict[str, np.ndarray], extra: dict):
        d = _step_dir(self.directory, step)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _ARRAYS), **arrays)
        with open(os.path.join(tmp, _ARRAYS), "rb") as f:
            blob_crc = zlib.crc32(f.read())
        crcs = {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                for k, v in arrays.items()}
        manifest = {"step": step, "blob_crc": blob_crc, "leaf_crcs": crcs,
                    "extra": extra}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)  # atomic commit
        log.info("saved checkpoint step %d (%d leaves)", step, len(arrays))
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def list_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.directory)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.directory, name, _MANIFEST)):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def validate(self, step: int) -> bool:
        d = _step_dir(self.directory, step)
        try:
            with open(os.path.join(d, _MANIFEST)) as f:
                manifest = json.load(f)
            with open(os.path.join(d, _ARRAYS), "rb") as f:
                return zlib.crc32(f.read()) == manifest["blob_crc"]
        except (OSError, json.JSONDecodeError, KeyError):
            return False

    def restore(self, step: int) -> Tuple[Dict[str, np.ndarray], dict]:
        """(arrays, extra) of ``step``: its path -> array map, which
        ``training.train_loop.load_state_tree`` copies into a state and
        checks leaf by leaf."""
        d = _step_dir(self.directory, step)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, _ARRAYS)) as z:
            arrays = {k: z[k] for k in z.files}
        return arrays, manifest.get("extra", {})

    def restore_latest(self):
        """(step, arrays, extra) of the newest checkpoint that passes CRC
        validation — a corrupted tail (a crash mid-save) falls back to
        the previous step — or (None, None, {})."""
        for step in reversed(self.list_steps()):
            if self.validate(step):
                arrays, extra = self.restore(step)
                return step, arrays, extra
            log.warning("checkpoint step %d failed validation; skipping",
                        step)
        return None, None, {}

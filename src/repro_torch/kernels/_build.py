"""Build and load the port's CUDA kernels.

Each source ``src/repro_torch/csrc/<name>.cu`` has a plain C interface
and is compiled with ``nvcc`` for Hopper (``sm_90a``) into its own shared
library, loaded with ``ctypes``.  Libraries land in ``build/kernels/``
at the root of the checkout (git-ignored), in a directory named by a
hash of the sources and of its own flags, so a changed source or flag
is rebuilt and an unchanged one is reused.  :func:`build_all` starts
one ``nvcc`` per source, all at once, and waits for them; :func:`load`
builds on first use.  Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
_ROOT = _PKG.parents[1]
BUILD_ROOT = _ROOT / "build" / "kernels"

SOURCES = ("fused_reuse", "ripple_attention", "sparse_attention", "adaln",
           "flash_attention", "reuse_snap")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# --fmad=false keeps every mul+add pair rounded separately.  fused_reuse
# and reuse_snap are held bit for bit to their plain versions and adaln to
# one output ulp, so they need it; sparse keeps it because its CUDA-core
# path's checks were last run with it (its tensor-core path writes its
# FMAs out).  ripple_attention and flash_attention build without it: their
# softmax scale and exponent arguments fuse into FFMAs, within their bars.
# The attention sources include csrc/hopper.cuh (and through it
# mma_frag.cuh); every header goes into every library's build key.  No source links a
# library: the TMA kernels (ripple, sparse) look up the tensor-map encoder
# (cuTensorMapEncodeTiled) at run time, not through -lcuda.
SOURCE_FLAGS = {name: ("--fmad=false",) for name in
                ("fused_reuse", "reuse_snap", "adaln", "sparse_attention")}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], object] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels); "
                       "put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def nvcc_flags(name: str) -> tuple:
    """The nvcc flags of ``csrc/<name>.cu``: the common ones and its own."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(nvcc_flags(name)).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        if p.stem == name or p.suffix == ".cuh":
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / _digest(name) / f"lib{name}.so"


def _start(name: str):
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *nvcc_flags(name), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Build every missing library, one ``nvcc`` per source, started
    together.  Returns ``{name: {"path", "seconds", "log"}}``; raises
    with the compiler's output if a build fails."""
    names = list(names or SOURCES)
    t0 = time.perf_counter()
    built, running = {}, {}
    for n in names:
        if library_path(n).exists():
            built[n] = {"path": str(library_path(n)), "seconds": 0.0,
                        "log": "cached"}
        else:
            running[n] = _start(n)
    errors = []
    for n, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        built[n] = {"path": str(out), "seconds": time.perf_counter() - t0,
                    "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence,
             restype=ctypes.c_int):
    """``symbol`` of ``csrc/<name>.cu``'s library with its ctypes
    prototype, set when it is first looked up and kept after."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        _FUNCS[(name, symbol)] = fn
    return fn


def on_device(t):
    """A context that makes ``t``'s card current for a launch: nothing to
    do when it already is."""
    import torch

    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)

"""Build and load the port's CUDA kernels.

Each source ``src/repro_torch/csrc/<name>.cu`` has a plain C interface
and is compiled with ``nvcc`` for Hopper (``sm_90a``) into its own shared
library, loaded with ``ctypes``.  Libraries land in ``build/kernels/``
at the root of the checkout (git-ignored), in a directory named by a
hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per
source, all at once, and waits for them; :func:`load` builds on first
use.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
_ROOT = _PKG.parents[1]
BUILD_ROOT = _ROOT / "build" / "kernels"

SOURCES = ("fused_reuse", "ripple_attention", "sparse_attention", "adaln")
# --fmad=false keeps every mul+add pair rounded separately (the Δ-check
# is held to bit-equality with its plain version).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels); "
                       "put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
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
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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

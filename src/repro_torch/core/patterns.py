"""Offline pattern search: static per-(layer, head) attention structure
(DESIGN.md §16), the port's copy of ``repro/core/patterns.py``.

Many (layer, head) pairs of a video DiT have a fixed sparsity structure
(diagonal, multi-diagonal, sliding window) that an offline search finds
once; the runtime decision cost then drops to zero.  This module holds:

* a library of parametric **templates** (numpy) that render a boolean
  keep-mask and its SKIP/FULL/PARTIAL block map for any (T, H, W) grid
  and block shape, bit for bit as the JAX package renders them;
* the offline **search** (:func:`search_patterns`, driven by
  ``launch/pattern_search.py``), scored through the port's dispatch
  ``reference`` backend as the reference scores it;
* the versioned JSON **artifact** (schema ``repro-pattern/1``, the same
  file format and content-hash version as the JAX package's, so one file
  serves both);
* the policies ``static`` (constant maps) and ``rainfusion`` (static
  heads get their searched mask, dynamic heads ripple's snap path),
  registered when ``core.policy`` is imported.

PyTorch runs eagerly, so what ``jax.jit`` folds into the compiled program
as a constant is built here once and kept: each policy's constant plan
(the block map on the device, the bias or None, the savings) lives in a
store keyed by (artifact version, grid, heads, tokens, ``grid_slice``,
block shape, layer, device), an LRU bounded by the bytes of its plans;
:data:`plan_builds` counts the builds.  Where the reference's jitted
sampler folds one artifact in when it is traced, a served sampler here
holds a policy pinned to one artifact (:meth:`_ArtifactPolicy.pin`), so
a swap while a batch runs leaves that batch on the artifact it started
with; the policies' ``plan_token`` (the version) keys the dispatch plan
and the serving bucket, so traffic after a swap gets a sampler of its
own.

On the context-parallel ring (``core/ring.py``, DESIGN.md §14)
``static`` renders each shard's bias rows itself
(:meth:`StaticPatternPolicy.ring_bias_rows`); ``rainfusion`` does not
ring (``will_seq_shard`` False) and replicates the token axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import warnings
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import savings as savings_lib
from repro_torch.core.policy import (ReuseDecision, ReusePolicy, RipplePolicy,
                                     register_policy, snap_operand)

__all__ = [
    "TemplateSpec", "template", "render_keep", "render_block_map",
    "block_map_np", "default_bank", "default_template", "branch_of",
    "HeadAssignment", "PatternArtifact", "PATTERN_SCHEMA",
    "pattern_artifact_path", "load_pattern_artifact",
    "save_pattern_artifact", "active_artifact", "set_active_artifact",
    "install_artifact", "use_artifact", "pattern_keep", "search_patterns",
    "StaticPatternPolicy", "RainFusionPolicy", "clear_plans",
]

# Tile states of kernels/sparse (kept equal by tests/test_torch_patterns.py;
# importing the kernel wrapper here is not needed to load an artifact).
_SKIP, _FULL, _PARTIAL = 0, 1, 2


# ---------------------------------------------------------------------------
# Template library
# ---------------------------------------------------------------------------

def _token_coords(grid: Tuple[int, int, int]):
    """Per-token (frame, site, y, x) indices in the raster layout the
    rest of the repo uses: frame-major, then y, then x."""
    t, h, w = grid
    idx = np.arange(t * h * w)
    frame = idx // (h * w)
    site = idx % (h * w)
    return frame, site, site // w, site % w


def _render_dense(grid, **_):
    n = int(np.prod(grid))
    return np.ones((n, n), bool)


def _render_frame_diag(grid, window: int = 1, sink: int = 1):
    """Sliding window over frames (|f_q − f_k| < window) plus optional
    global-sink columns for the first ``sink`` frames."""
    f, _, _, _ = _token_coords(grid)
    keep = np.abs(f[:, None] - f[None, :]) < max(int(window), 1)
    if sink > 0:
        keep |= (f[None, :] < int(sink))
    return keep


def _render_multi_diag(grid, stride: int = 2, sink: int = 0):
    """Multi-diagonal over frames: keep frame pairs whose offset is a
    multiple of ``stride`` (Sparse-vDiT's strided-attention family)."""
    f, _, _, _ = _token_coords(grid)
    df = np.abs(f[:, None] - f[None, :])
    keep = (df % max(int(stride), 1)) == 0
    if sink > 0:
        keep |= (f[None, :] < int(sink))
    return keep


def _render_spatial_local(grid, radius: int = 1, sink_tokens: int = 0):
    """Within-frame Chebyshev neighbourhood: same frame and
    max(|Δx|, |Δy|) ≤ radius — the T=1 (image) family."""
    f, _, y, x = _token_coords(grid)
    r = max(int(radius), 0)
    keep = ((f[:, None] == f[None, :])
            & (np.abs(y[:, None] - y[None, :]) <= r)
            & (np.abs(x[:, None] - x[None, :]) <= r))
    if sink_tokens > 0:
        keep[:, :int(sink_tokens)] = True
    return keep


def _render_temporal_stride(grid, halo: int = 1, stride: int = 1):
    """Same spatial site (± halo in raster distance) across frames,
    optionally only at frame offsets that are multiples of ``stride``."""
    f, s, _, _ = _token_coords(grid)
    keep = np.abs(s[:, None] - s[None, :]) <= max(int(halo), 0)
    if stride > 1:
        keep &= (np.abs(f[:, None] - f[None, :]) % int(stride)) == 0
    return keep


def _render_global_sink(grid, tokens: int = 0):
    """Self-diagonal plus the first ``tokens`` global-sink columns
    (default: one frame's worth) — the textural/global family."""
    t, h, w = grid
    n = t * h * w
    cols = int(tokens) if tokens > 0 else h * w
    keep = np.eye(n, dtype=bool)
    keep[:, :min(cols, n)] = True
    return keep


TEMPLATE_FAMILIES: Dict[str, Callable[..., np.ndarray]] = {
    "dense": _render_dense,
    "frame_diag": _render_frame_diag,
    "multi_diag": _render_multi_diag,
    "spatial_local": _render_spatial_local,
    "temporal_stride": _render_temporal_stride,
    "global_sink": _render_global_sink,
}

# RainFusion's tri-branch routing: which redundancy branch a winning
# family corresponds to.  ``dense`` winners are by definition dynamic.
_BRANCH_OF = {
    "dense": "dynamic",
    "frame_diag": "spatial",
    "spatial_local": "spatial",
    "multi_diag": "temporal",
    "temporal_stride": "temporal",
    "global_sink": "textural",
}


@dataclasses.dataclass(frozen=True)
class TemplateSpec:
    """One parametric template: a family name plus a sorted tuple of
    (param, int-value) pairs — hashable so search can count winners."""

    family: str
    params: Tuple[Tuple[str, int], ...] = ()

    @property
    def label(self) -> str:
        kv = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.family}({kv})" if kv else self.family

    def to_json(self) -> dict:
        return {"family": self.family, "params": dict(self.params)}

    @classmethod
    def from_json(cls, obj) -> "TemplateSpec":
        if not isinstance(obj, dict) or "family" not in obj:
            raise ValueError(f"malformed template spec: {obj!r}")
        fam = obj["family"]
        if fam not in TEMPLATE_FAMILIES:
            raise ValueError(f"unknown template family {fam!r}")
        params = obj.get("params", {})
        if not isinstance(params, dict):
            raise ValueError(f"malformed template params: {params!r}")
        return template(fam, **{str(k): int(v) for k, v in params.items()})


def template(family: str, **params: int) -> TemplateSpec:
    if family not in TEMPLATE_FAMILIES:
        raise ValueError(f"unknown template family {family!r}; known: "
                         f"{sorted(TEMPLATE_FAMILIES)}")
    return TemplateSpec(family,
                        tuple(sorted((k, int(v)) for k, v in params.items())))


def branch_of(spec: TemplateSpec) -> str:
    return _BRANCH_OF.get(spec.family, "textural")


def render_keep(spec: TemplateSpec,
                grid: Tuple[int, int, int]) -> np.ndarray:
    """(N, N) boolean keep-mask for ``spec`` on ``grid``.  The identity
    diagonal is always kept — no template may mask a token's own key."""
    keep = TEMPLATE_FAMILIES[spec.family](tuple(grid), **dict(spec.params))
    np.fill_diagonal(keep, True)
    return keep


def block_map_np(keep: np.ndarray, block_q: int, block_k: int) -> np.ndarray:
    """NumPy mirror of ``kernels.sparse.ops.block_map_from_keep`` (edge
    padding, same clamping), so the PARTIAL-free test of a constant mask
    is a host property."""
    n_q, n_k = keep.shape[-2:]
    bq = min(block_q, max(n_q, 1))
    bk = min(block_k, max(n_k, 1))
    nq, nk = -(-n_q // bq), -(-n_k // bk)
    widths = [(0, 0)] * (keep.ndim - 2) + [(0, nq * bq - n_q),
                                           (0, nk * bk - n_k)]
    tiled = np.pad(keep, widths, mode="edge") \
        .reshape(*keep.shape[:-2], nq, bq, nk, bk)
    any_keep = tiled.any(axis=(-3, -1))
    all_keep = tiled.all(axis=(-3, -1))
    return np.where(all_keep, _FULL,
                    np.where(any_keep, _PARTIAL, _SKIP)).astype(np.int32)


def render_block_map(spec: TemplateSpec, grid: Tuple[int, int, int],
                     block_shape: Tuple[int, int]) -> np.ndarray:
    return block_map_np(render_keep(spec, grid), *block_shape)


def template_skip_rate(spec: TemplateSpec, grid: Tuple[int, int, int],
                       block_shape: Tuple[int, int]) -> float:
    bm = render_block_map(spec, grid, block_shape)
    return float((bm == _SKIP).mean())


def default_template(grid: Tuple[int, int, int]) -> TemplateSpec:
    """Conservative fallback when no artifact entry covers a head:
    frame-diagonal + first-frame sink for video grids, a spatial window
    for T=1 image grids (spatial-only reuse)."""
    t, h, w = grid
    if t > 1:
        return template("frame_diag", window=1, sink=1)
    return template("spatial_local", radius=max(1, min(h, w) // 4))


def default_bank(grid: Tuple[int, int, int]) -> List[TemplateSpec]:
    """Candidate templates the search scores on ``grid``.  Video grids
    get the temporal families; T=1 grids get the spatial-only bank."""
    t, h, w = grid
    bank = [template("dense")]
    if t > 1:
        bank += [template("frame_diag", window=1, sink=1),
                 template("frame_diag", window=2, sink=1),
                 template("temporal_stride", halo=1),
                 template("temporal_stride", halo=w)]
        if t >= 4:
            bank.append(template("multi_diag", stride=2, sink=1))
    if min(h, w) >= 4:
        bank.append(template("spatial_local", radius=1))
        if min(h, w) >= 8:
            bank.append(template("spatial_local", radius=min(h, w) // 4))
    bank.append(template("global_sink"))
    return bank


# ---------------------------------------------------------------------------
# The versioned per-(layer, head) assignment artifact
# ---------------------------------------------------------------------------

PATTERN_SCHEMA = "repro-pattern/1"


@dataclasses.dataclass(frozen=True)
class HeadAssignment:
    """Search verdict for one (layer, head): the winning template, the
    static-vs-dynamic classification, and the evidence behind it."""

    spec: TemplateSpec
    static: bool
    branch: str          # spatial | temporal | textural | dynamic
    psnr_db: float       # worst-case PSNR of the winner vs reference
    skip_rate: float     # realized skipped-tile fraction at search block
    stability: float     # fraction of samples that voted for the winner

    def to_json(self) -> dict:
        return {"template": self.spec.to_json(), "static": self.static,
                "branch": self.branch, "psnr_db": round(self.psnr_db, 3),
                "skip_rate": round(self.skip_rate, 4),
                "stability": round(self.stability, 4)}

    @classmethod
    def from_json(cls, obj) -> "HeadAssignment":
        if not isinstance(obj, dict) or "template" not in obj:
            raise ValueError(f"malformed head assignment: {obj!r}")
        return cls(spec=TemplateSpec.from_json(obj["template"]),
                   static=bool(obj.get("static", False)),
                   branch=str(obj.get("branch", "dynamic")),
                   psnr_db=float(obj.get("psnr_db", 0.0)),
                   skip_rate=float(obj.get("skip_rate", 0.0)),
                   stability=float(obj.get("stability", 0.0)))


@dataclasses.dataclass
class PatternArtifact:
    """The searched per-(layer, head) assignment table.

    ``version`` is a content hash over the payload — it keys the
    constant-plan store, so swapping artifacts can never replay a stale
    plan (DESIGN.md §16)."""

    grid: Tuple[int, int, int]
    block_shape: Tuple[int, int]
    tolerance_db: float
    heads: Dict[Tuple[int, int], HeadAssignment]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.grid = tuple(int(g) for g in self.grid)
        self.block_shape = tuple(int(b) for b in self.block_shape)
        self._keep_cache: Dict[tuple, np.ndarray] = {}

    # -- content-hash version -------------------------------------------

    def _payload(self) -> dict:
        return {
            "schema": PATTERN_SCHEMA,
            "grid": list(self.grid),
            "block_shape": list(self.block_shape),
            "tolerance_db": self.tolerance_db,
            "heads": {f"{l}/{h}": a.to_json()
                      for (l, h), a in sorted(self.heads.items())},
            "meta": self.meta,
        }

    @property
    def version(self) -> str:
        blob = json.dumps(self._payload(), sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:12]

    # -- lookups ---------------------------------------------------------

    def static_fraction(self) -> float:
        if not self.heads:
            return 0.0
        return sum(a.static for a in self.heads.values()) / len(self.heads)

    def _majority(self, entries: Sequence[HeadAssignment]
                  ) -> Optional[HeadAssignment]:
        """Modal *static* assignment among ``entries`` (dynamic if the
        static votes don't reach half) — the layer-consolidation rule
        used when the caller can't name a layer (DESIGN.md §16)."""
        statics = [a for a in entries if a.static]
        if not entries or 2 * len(statics) < len(entries):
            return None
        counts: Dict[TemplateSpec, List[HeadAssignment]] = {}
        for a in statics:
            counts.setdefault(a.spec, []).append(a)
        spec, votes = max(counts.items(), key=lambda kv: len(kv[1]))
        return min(votes, key=lambda a: a.psnr_db)

    def assignment(self, layer: Optional[int],
                   head: int) -> Optional[HeadAssignment]:
        """Assignment for (layer, head): exact entry, else the majority
        vote over layers for this head, else the global majority.  None
        means dynamic / no stable pattern."""
        if layer is not None and (layer, head) in self.heads:
            a = self.heads[(layer, head)]
            return a if a.static else None
        per_head = [a for (l, h), a in self.heads.items() if h == head]
        got = self._majority(per_head)
        if got is not None or per_head:
            return got
        return self._majority(list(self.heads.values()))

    def keep_for(self, grid: Tuple[int, int, int], n_heads: int,
                 layer: Optional[int] = None) -> np.ndarray:
        """(n_heads, N, N) boolean keep — dynamic heads are all-True.
        Templates are parametric, so any runtime ``grid`` works, not
        just the grid the search ran on."""
        key = (tuple(grid), n_heads, layer)
        hit = self._keep_cache.get(key)
        if hit is not None:
            return hit
        n = int(np.prod(grid))
        keep = np.ones((n_heads, n, n), bool)
        for h in range(n_heads):
            a = self.assignment(layer, h)
            if a is not None:
                keep[h] = render_keep(a.spec, grid)
        self._keep_cache[key] = keep
        return keep

    def branches(self, n_heads: int,
                 layer: Optional[int] = None) -> List[str]:
        out = []
        for h in range(n_heads):
            a = self.assignment(layer, h)
            out.append(a.branch if a is not None else "dynamic")
        return out

    # -- serialization ---------------------------------------------------

    def to_json(self) -> dict:
        obj = self._payload()
        obj["version"] = self.version
        return obj

    @classmethod
    def from_json(cls, obj) -> "PatternArtifact":
        if not isinstance(obj, dict):
            raise ValueError(f"pattern artifact must be an object, got "
                             f"{type(obj).__name__}")
        schema = obj.get("schema")
        if schema != PATTERN_SCHEMA:
            raise ValueError(f"pattern artifact schema {schema!r} != "
                             f"{PATTERN_SCHEMA!r}")
        heads: Dict[Tuple[int, int], HeadAssignment] = {}
        raw = obj.get("heads", {})
        if not isinstance(raw, dict):
            raise ValueError(f"malformed heads table: {raw!r}")
        for key, val in raw.items():
            l, _, h = str(key).partition("/")
            heads[(int(l), int(h))] = HeadAssignment.from_json(val)
        grid = obj.get("grid", ())
        block = obj.get("block_shape", ())
        if len(grid) != 3 or len(block) != 2:
            raise ValueError(f"malformed grid/block_shape: "
                             f"{grid!r}/{block!r}")
        return cls(grid=tuple(grid), block_shape=tuple(block),
                   tolerance_db=float(obj.get("tolerance_db", 0.0)),
                   heads=heads, meta=obj.get("meta", {}) or {})


def pattern_artifact_path() -> str:
    """The ``REPRO_PATTERN_ARTIFACT`` env var, else the user cache dir
    (the JAX package's resolution order, so both read one file)."""
    env = os.environ.get("REPRO_PATTERN_ARTIFACT", "")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro_timeripple", "patterns.json")


def load_pattern_artifact(path: Optional[str] = None
                          ) -> Optional[PatternArtifact]:
    """Load the artifact: a missing file is None (quietly), corrupt JSON
    or a mismatched schema warns and returns None so callers regenerate
    instead of crashing the launcher (DESIGN.md §16)."""
    p = path or pattern_artifact_path()
    try:
        with open(p, "r", encoding="utf-8") as f:
            obj = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        warnings.warn(f"pattern artifact {p!r} is corrupt ({e}); ignoring "
                      f"it — re-run pattern_search to regenerate",
                      RuntimeWarning, stacklevel=2)
        return None
    try:
        return PatternArtifact.from_json(obj)
    except (ValueError, TypeError, KeyError) as e:
        warnings.warn(f"pattern artifact {p!r} does not match schema "
                      f"{PATTERN_SCHEMA!r} ({e}); ignoring it — re-run "
                      f"pattern_search to regenerate",
                      RuntimeWarning, stacklevel=2)
        return None


def save_pattern_artifact(artifact: PatternArtifact,
                          path: Optional[str] = None) -> str:
    """Atomic, durable write: a temporary file in the target directory,
    fsync'd, then renamed over the target, so an artifact written just
    before a crash is either fully present or absent, never torn."""
    p = path or pattern_artifact_path()
    d = os.path.dirname(os.path.abspath(p))
    os.makedirs(d, exist_ok=True)
    text = json.dumps(artifact.to_json(), indent=1, sort_keys=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".patterns.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return p


# -- the process-wide active artifact ---------------------------------------

_ACTIVE: Optional[PatternArtifact] = None      # explicit install
_AUTO: Optional[Tuple[str, Optional[PatternArtifact]]] = None  # lazy load


def active_artifact() -> Optional[PatternArtifact]:
    """The artifact the pattern policies consult: an explicitly
    installed one, else a lazy load from :func:`pattern_artifact_path`
    (cached per resolved path, so flipping the env var takes effect)."""
    global _AUTO
    if _ACTIVE is not None:
        return _ACTIVE
    p = pattern_artifact_path()
    if _AUTO is None or _AUTO[0] != p:
        _AUTO = (p, load_pattern_artifact(p))
    return _AUTO[1]


def set_active_artifact(artifact: Optional[PatternArtifact]
                        ) -> Optional[PatternArtifact]:
    """Install (or with None, uninstall) the active artifact.  The
    constant-plan store is left as it is: a batch still running on a
    sampler pinned to the old artifact keeps using its plans (keyed by
    their version), and the store's byte bound evicts them once newer
    plans need the room."""
    global _ACTIVE, _AUTO
    prev = _ACTIVE
    _ACTIVE = artifact
    _AUTO = None
    return prev


def install_artifact(path: str) -> PatternArtifact:
    """Load ``path`` and install it; raises on a missing or corrupt
    file — an *explicit* ``--pattern-artifact`` must fail loudly rather
    than silently serve the default templates."""
    art = load_pattern_artifact(path)
    if art is None:
        raise ValueError(f"no usable pattern artifact at {path!r}")
    set_active_artifact(art)
    return art


@contextlib.contextmanager
def use_artifact(artifact: Optional[PatternArtifact]):
    prev = set_active_artifact(artifact)
    try:
        yield artifact
    finally:
        set_active_artifact(prev)


def pattern_keep(artifact: Optional[PatternArtifact],
                 grid: Tuple[int, int, int], n_heads: int,
                 layer: Optional[int] = None) -> np.ndarray:
    """(n_heads, N, N) keep that ``static`` applies: the artifact's
    searched assignments when one is active, else the per-grid default
    template on every head (so ``--policy static`` stays runnable
    standalone).  The policies build the same per head once, through
    the constant-plan store."""
    if artifact is not None:
        return artifact.keep_for(grid, n_heads, layer=layer)
    n = int(np.prod(grid))
    keep = render_keep(default_template(tuple(grid)), tuple(grid))
    return np.broadcast_to(keep, (n_heads, n, n))


# ---------------------------------------------------------------------------
# The offline search
# ---------------------------------------------------------------------------

def _psnr_per_head(ref: torch.Tensor, out: torch.Tensor) -> np.ndarray:
    """(H,) PSNR in dB of ``out`` vs ``ref`` for (B, H, N, d) outputs."""
    axes = tuple(i for i in range(ref.ndim) if i != 1)
    mse = torch.mean(torch.square(ref - out), dim=axes)
    peak = torch.amax(torch.abs(ref), dim=axes)
    psnr = 10.0 * torch.log10(torch.square(peak)
                              / torch.clamp(mse, min=1e-12))
    return psnr.cpu().numpy().astype(np.float64)


def search_patterns(samples: Iterable[Tuple[int, torch.Tensor, torch.Tensor,
                                            torch.Tensor]],
                    grid: Tuple[int, int, int], *,
                    block_shape: Tuple[int, int] = (128, 128),
                    tolerance_db: float = 30.0,
                    stability_min: float = 0.6,
                    bank: Optional[Sequence[TemplateSpec]] = None,
                    meta: Optional[Dict[str, object]] = None
                    ) -> PatternArtifact:
    """Score every template per (layer, head) on calibration traffic.

    ``samples`` yields ``(layer, q, k, v)`` with (B, H, N, d) operands —
    one entry per (layer, prompt, step) calibration point.  Every
    sample votes: the winner for a head is the highest-skip template
    whose PSNR vs reference attention stays ≥ ``tolerance_db``.  A head
    is **static** iff the same non-dense template wins on at least
    ``stability_min`` of its samples *and* its worst-case PSNR clears
    the tolerance; everything else is dynamic (DESIGN.md §16).
    """
    from repro_torch.config.base import RippleConfig
    from repro_torch.core.dispatch import attention_dispatch

    grid = tuple(int(g) for g in grid)
    bank = list(bank) if bank is not None else default_bank(grid)
    off = RippleConfig(enabled=False)

    # Each candidate is rendered once (its bias moves to the samples'
    # device at first use); scoring runs through the dispatch path
    # (reference backend + external bias), the math the runtime executes.
    keeps = {}
    skips = {}
    density = {}  # masked score fraction — tie-breaks equal skip rates
    for spec in bank:
        keep = render_keep(spec, grid)
        keeps[spec] = keep
        skips[spec] = float((block_map_np(keep, *block_shape)
                             == _SKIP).mean())  # template_skip_rate
        density[spec] = 1.0 - float(keep.mean())
    biases: Dict[TemplateSpec, torch.Tensor] = {}

    votes: Dict[Tuple[int, int], List[TemplateSpec]] = {}
    worst_psnr: Dict[Tuple[int, int, TemplateSpec], float] = {}
    n_samples = 0
    for layer, q, k, v in samples:
        n_samples += 1
        n_heads = q.shape[1]
        ref = attention_dispatch(q, k, v, grid=grid, cfg=off,
                                 backend="reference")
        scored = []
        for spec in bank:
            if spec.family == "dense":
                psnr = np.full((n_heads,), np.inf)
            else:
                if spec not in biases:
                    biases[spec] = torch.where(
                        torch.from_numpy(keeps[spec]).to(q.device), 0.0,
                        float("-inf")).float()
                out = attention_dispatch(q, k, v, grid=grid, cfg=off,
                                         backend="reference",
                                         bias=biases[spec])
                psnr = _psnr_per_head(ref, out)
                del out
            scored.append((spec, psnr))
            for h in range(n_heads):
                key = (int(layer), h, spec)
                worst_psnr[key] = min(worst_psnr.get(key, np.inf),
                                      float(psnr[h]))
        for h in range(n_heads):
            ok = [(spec, p[h]) for spec, p in scored
                  if p[h] >= tolerance_db]
            # Most skipped tiles wins; masked score fraction tie-breaks
            # (small grids tile coarsely enough that several templates
            # share a skip rate — including dense's zero).
            winner = max(ok, key=lambda sp: (skips[sp[0]],
                                             density[sp[0]]))[0] if ok \
                else template("dense")
            votes.setdefault((int(layer), h), []).append(winner)

    heads: Dict[Tuple[int, int], HeadAssignment] = {}
    for (layer, h), cast in votes.items():
        counts: Dict[TemplateSpec, int] = {}
        for spec in cast:
            counts[spec] = counts.get(spec, 0) + 1
        winner, n_votes = max(counts.items(), key=lambda kv: kv[1])
        stability = n_votes / len(cast)
        wpsnr = worst_psnr.get((layer, h, winner), 0.0)
        static = (winner.family != "dense"
                  and stability >= stability_min
                  and wpsnr >= tolerance_db)
        spec = winner if static else template("dense")
        heads[(layer, h)] = HeadAssignment(
            spec=spec, static=static,
            branch=branch_of(winner) if static else "dynamic",
            psnr_db=min(wpsnr, 1e9), skip_rate=skips[spec],
            stability=stability)

    info = {"samples": n_samples, "stability_min": stability_min,
            "bank": [s.label for s in bank]}
    info.update(meta or {})
    return PatternArtifact(grid=grid, block_shape=tuple(block_shape),
                           tolerance_db=float(tolerance_db), heads=heads,
                           meta=info)


# ---------------------------------------------------------------------------
# Constant plans, built once
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ConstantPlan:
    """A policy's constant plan at one key on one device: the (H, nq, nk)
    block map (None without a block shape), the (H, N, N) f32 bias (-inf
    off the keep; None when the block map has no PARTIAL tile, which
    never reads it), the savings (1 - the kept share of the (H, N, N)
    keep, a 0-d f32 tensor) and the heads left dynamic, (H, 1, 1) bool."""

    block_map: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    savings: torch.Tensor
    dynamic: torch.Tensor

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.block_map, self.bias) if t is not None)


# An LRU bounded by the bytes of its plans: a rainfusion plan at the
# served vDiT grid holds a (24, 8448, 8448) f32 bias, 6.85 GB, so a
# server that meets several grids or token counts keeps only the newest
# plans.  The newest plan is kept whatever its size.
# The store is shared by every engine thread of a process (router
# replicas on one card): a lock guards it, held across a build so that a
# key is built once.
_PLAN_STORE_BYTES = 8 << 30
_PLANS: "OrderedDict[tuple, ConstantPlan]" = OrderedDict()
_PLANS_LOCK = threading.Lock()
plan_builds = 0  # constant plans built (one per store key)


def clear_plans() -> None:
    """Drop every stored constant plan (the count of builds stays)."""
    with _PLANS_LOCK:
        _PLANS.clear()


def plan_store() -> Dict[tuple, ConstantPlan]:
    """The stored constant plans by key, oldest first (for inspection)."""
    with _PLANS_LOCK:
        return dict(_PLANS)


def _make_room(nbytes: int) -> None:
    """Evict the oldest plans until ``nbytes`` more fit the budget (the
    caller holds ``_PLANS_LOCK``)."""
    used = sum(p.nbytes for p in _PLANS.values())
    while _PLANS and used + nbytes > _PLAN_STORE_BYTES:
        used -= _PLANS.popitem(last=False)[1].nbytes


def _paste(keep: np.ndarray, n_tokens: int,
           grid_slice: Optional[Tuple[int, int]]) -> np.ndarray:
    """Embed a grid-segment (N_g, N_g) keep into the full token range
    (text-prefix layouts): everything outside the video segment stays
    unmasked, the convention of ``svg_logit_bias``."""
    if grid_slice is None:
        return keep
    s, n = grid_slice
    full = np.ones((n_tokens, n_tokens), bool)
    full[s:s + n, s:s + n] = keep
    return full


def _constant_plan(kind: str, specs: Sequence[Optional[TemplateSpec]],
                   version, grid: Tuple[int, int, int], n_tokens: int,
                   grid_slice: Optional[Tuple[int, int]], layer,
                   block_shape: Optional[Tuple[int, int]], device,
                   bias_always: bool = False) -> ConstantPlan:
    """The stored :class:`ConstantPlan` of ``specs`` (one a head, None for
    a head that keeps every key), built at its first use: each distinct
    spec rendered and pasted once on the host, its block map made there
    (``block_map_np``, bit-equal to the reference's) and gathered per
    head onto the device; the bias built on the device, only when some
    tile is PARTIAL, no block shape was given, or ``bias_always``."""
    device = torch.device(device)
    key = (kind, version, tuple(grid), len(specs), n_tokens,
           None if grid_slice is None else tuple(grid_slice), layer,
           None if block_shape is None else tuple(block_shape), str(device))
    with _PLANS_LOCK:
        return _stored_plan(key, specs, grid, n_tokens, grid_slice,
                            block_shape, device, bias_always)


def _stored_plan(key, specs, grid, n_tokens, grid_slice, block_shape,
                 device, bias_always) -> ConstantPlan:
    """The body of :func:`_constant_plan`, under ``_PLANS_LOCK``."""
    global plan_builds
    plan = _PLANS.get(key)
    if plan is not None:
        _PLANS.move_to_end(key)
        return plan
    uniq: Dict[Optional[TemplateSpec], int] = {}
    keeps: List[np.ndarray] = []
    n = int(np.prod(grid))
    for spec in specs:
        if spec not in uniq:
            seg = (np.ones((n, n), bool) if spec is None
                   else render_keep(spec, grid))
            uniq[spec] = len(keeps)
            keeps.append(_paste(seg, n_tokens, grid_slice))
    head_keep = [uniq[s] for s in specs]
    # The mean of the (heads, N, N) keep, one rounding as numpy's mean.
    kept = sum(int(np.count_nonzero(keeps[i])) for i in head_keep)
    savings = 1.0 - kept / float(len(specs) * n_tokens * n_tokens)
    maps = None
    need_bias = True
    if block_shape is not None:
        maps = [block_map_np(keep, *block_shape) for keep in keeps]
        need_bias = bias_always or any(bool((m == _PARTIAL).any())
                                       for m in maps)
    _make_room(len(specs) * 4 * ((maps[0].size if maps else 0)
                                 + (n_tokens ** 2 if need_bias else 0)))
    block_map = None
    if maps is not None:
        block_map = torch.from_numpy(
            np.stack([maps[i] for i in head_keep])).to(device)
    bias = None
    if need_bias:
        slabs = [torch.where(torch.from_numpy(keep).to(device), 0.0,
                             float("-inf")).float() for keep in keeps]
        bias = torch.empty((len(specs), n_tokens, n_tokens),
                           dtype=torch.float32, device=device)
        for h, i in enumerate(head_keep):
            bias[h].copy_(slabs[i])
        del slabs
    plan = ConstantPlan(
        block_map=block_map, bias=bias,
        savings=torch.tensor(np.float32(savings), device=device),
        dynamic=torch.tensor([s is None for s in specs],
                             device=device)[:, None, None])
    _PLANS[key] = plan
    plan_builds += 1
    return plan


# ---------------------------------------------------------------------------
# The policies
# ---------------------------------------------------------------------------

def _n_heads(q: torch.Tensor) -> int:
    return q.shape[1] if q.ndim >= 4 else 1


class _ArtifactPolicy:
    """What both pattern policies share: the artifact they consult and
    their per-head specs' constant plan.  The registered instances
    consult :func:`active_artifact` at every call; one made with an
    ``artifact``, or with ``pinned=True`` (:meth:`pin`), consults that
    artifact only (None: the default templates)."""

    def __init__(self, artifact: Optional[PatternArtifact] = None,
                 layer: Optional[int] = None, *, pinned: bool = False):
        self._artifact = artifact
        self._pinned = pinned or artifact is not None
        self.layer = layer

    def artifact(self) -> Optional[PatternArtifact]:
        return self._artifact if self._pinned else active_artifact()

    def pin(self) -> "_ArtifactPolicy":
        """A copy of this policy held to the artifact it consults now,
        whatever is installed later."""
        return type(self)(self.artifact(), self.layer, pinned=True)

    def plan_token(self, cfg=None) -> Optional[str]:
        art = self.artifact()
        return art.version if art is not None else None

    def _specs(self, n_heads: int, grid) -> List[Optional[TemplateSpec]]:
        raise NotImplementedError

    def _plan(self, q, specs, grid, grid_slice, block_shape,
              bias_always: bool = False) -> ConstantPlan:
        art = self.artifact()
        if grid_slice is not None and tuple(grid_slice) == (0, q.shape[-2]):
            grid_slice = None
        return _constant_plan(self.name, specs,
                              None if art is None else art.version, grid,
                              q.shape[-2], grid_slice, self.layer,
                              block_shape, q.device, bias_always)


class StaticPatternPolicy(_ArtifactPolicy, ReusePolicy):
    """Constant searched masks: zero runtime decision cost.

    The keep-mask per head comes from the active pattern artifact (or the
    per-grid default template when none is installed); its plan (block
    map, bias or None, savings) is built once per key and then handed
    out as it is, and ``plan_once`` tells the decision cache to refresh
    at step 0 only (DESIGN.md §16).  When the map has no PARTIAL tile
    the N×N bias is never built: the block map alone carries the
    structure.
    """

    name = "static"
    emits_bias = True
    snaps_operands = False
    emits_block_map = True
    caches_decisions = True
    plan_once = True

    def _specs(self, n_heads, grid):
        art = self.artifact()
        if art is None:
            return [default_template(grid)] * n_heads
        specs = []
        for h in range(n_heads):
            a = art.assignment(self.layer, h)
            specs.append(a.spec if a is not None else None)
        return specs

    def will_seq_shard(self, cfg):
        # Constant masks are row-separable: each shard renders its own
        # bias rows (ring_bias_rows), and all-SKIP ring hops fall out of
        # the constant map.
        return True

    def ring_bias_rows(self, q, k, *, grid, cfg, row_offset: int,
                       n_rows: int) -> torch.Tensor:
        """A ring shard's bias rows: rows ``row_offset`` to ``row_offset
        + n_rows`` of the constant (H, N, N) bias (built once per key, as
        every constant plan), broadcast over q's leading dims.  No
        collectives: the mask is position-determined."""
        n = int(np.prod(grid))
        plan = _constant_plan(
            self.name, self._specs(_n_heads(q), tuple(grid)),
            None if self.artifact() is None else self.artifact().version,
            tuple(grid), n, None, self.layer, None, q.device,
            bias_always=True)
        rows = plan.bias[:, row_offset:row_offset + n_rows]
        lead = q.shape[:-2] if q.ndim >= 4 else (q.shape[0],)
        return rows.expand(tuple(lead) + tuple(rows.shape[-2:]))

    def decide(self, q, k, *, grid, cfg, thetas, bias=None, grid_slice=None,
               fused=False, block_shape=None, want_plan=False):
        plan = self._plan(q, self._specs(_n_heads(q), tuple(grid)), grid,
                          grid_slice, block_shape)
        if plan.bias is not None:
            bias = plan.bias if bias is None else bias + plan.bias
        return ReuseDecision(q=q, k=k, thetas=thetas, bias=bias,
                             savings=plan.savings,
                             block_map=plan.block_map)

    def apply_decision(self, q, k, cached, *, grid, cfg, thetas,
                       grid_slice=None, block_shape=None):
        # A passthrough: the cached bias and map as they are, the savings
        # the stored plan's — no per-step work, the point of plan_once.
        plan = self._plan(q, self._specs(_n_heads(q), tuple(grid)), grid,
                          grid_slice, block_shape)
        return ReuseDecision(q=q, k=k, thetas=thetas, bias=cached.bias,
                             savings=plan.savings,
                             block_map=cached.block_map)


class RainFusionPolicy(_ArtifactPolicy, RipplePolicy):
    """Tri-branch routing: each head goes to its searched spatial /
    temporal / textural mask when the artifact classified it static,
    and falls back to the adaptive ripple snap path when dynamic.

    Static heads get the constant keep-mask (bias + block map, built
    once per key) and *identity* snap sources; dynamic heads get
    ripple's windowed Δ-check snapping.  With no artifact installed
    every head is dynamic, the map is None (every tile runs) and the
    policy degrades to ripple on the sparse backend."""

    name = "rainfusion"
    emits_bias = True
    emits_block_map = True

    def will_emit_bias(self, cfg):
        return True

    def will_emit_block_map(self, cfg):
        return True

    def will_seq_shard(self, cfg):
        # Mixing the mask and snap paths on the ring would need both
        # fused shard-locally, which the ring does not do.
        return False

    def _specs(self, n_heads, grid):
        art = self.artifact()
        specs = [None] * n_heads
        if art is not None:
            for h in range(n_heads):
                a = art.assignment(self.layer, h)
                if a is not None:
                    specs[h] = a.spec
        return specs

    def decide(self, q, k, *, grid, cfg, thetas, bias=None, grid_slice=None,
               fused=False, block_shape=None, want_plan=False):
        specs = self._specs(_n_heads(q), tuple(grid))
        active_axes = tuple(cfg.axes)
        q_s, q_mask, *q_src = snap_operand(q, cfg.snap_q, grid, thetas, cfg,
                                           active_axes, grid_slice, fused,
                                           want_src=want_plan)
        k_s, k_mask, *k_src = snap_operand(k, cfg.snap_k, grid, thetas, cfg,
                                           active_axes, grid_slice, fused,
                                           want_src=want_plan)
        q_src = q_src[0] if q_src else None
        k_src = k_src[0] if k_src else None
        block_map = plan = None
        if any(s is not None for s in specs):
            # Static heads keep their original operands (their mask is
            # the whole decision); snapping applies to dynamic heads
            # only.  dyn aligns with the head axis (dim -3) of 4-D
            # operands; 3-D operands route as one consolidated head.
            plan = self._plan(q, specs, grid, grid_slice, block_shape,
                              bias_always=True)
            dyn = plan.dynamic
            q_s = torch.where(dyn, q_s, q)
            k_s = torch.where(dyn, k_s, k)
            if q_mask is not None:
                q_mask = q_mask & dyn
            if k_mask is not None:
                k_mask = k_mask & dyn
            if q_src is not None:
                q_src = torch.where(dyn, q_src, _identity_src(q_src))
            if k_src is not None:
                k_src = torch.where(dyn, k_src, _identity_src(k_src))
            bias = plan.bias if bias is None else bias + plan.bias
            block_map = plan.block_map
        if q_mask is not None and k_mask is not None:
            savings = savings_lib.partial_score_savings(q_mask, k_mask)
        else:
            savings = torch.zeros((), device=q.device)
        if plan is not None:
            savings = savings + plan.savings
        return ReuseDecision(
            q=q_s, k=k_s, thetas=thetas, bias=bias, q_mask=q_mask,
            k_mask=k_mask, savings=savings, block_map=block_map,
            q_src=q_src, k_src=k_src)

def _identity_src(src: torch.Tensor) -> torch.Tensor:
    """Identity gather indices matching a snap-source map's shape: the
    replay becomes a no-op for the masked (static) heads."""
    n = src.shape[-2]
    iota = torch.arange(n, dtype=src.dtype, device=src.device)[:, None]
    return iota.expand(src.shape)


register_policy(StaticPatternPolicy())
register_policy(RainFusionPolicy())

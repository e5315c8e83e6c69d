"""Typed configuration for the PyTorch port.

The port keeps its own copy of the dataclasses it needs, with the same
field names and defaults as the JAX package's ``repro.config.base``, so
that one config (and one ``key=value`` override string) means the same
thing in both packages.  The vDiT and DiT families are carried over so
far.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class RippleConfig:
    """Configuration of the TimeRipple reuse technique (paper §3.3).

    Snapping spatio-temporally similar (token, channel) entries of Q and
    K to their window representative is exactly equivalent to reusing
    their partial attention scores (DESIGN.md §2).  ``svg_mask`` composes
    the SVG block mask with the snapping (the block-sparse backend runs
    it).  Fields the port does not act on yet (the decision cache's
    ``reuse_every`` / ``drift_tol``, sentinels, 1-D reuse) keep their
    defaults so configs stay interchangeable; the serving launcher
    refuses decision-cache settings it cannot honour.
    """

    enabled: bool = False
    # Which grid axes participate in the similarity checks.
    axes: Tuple[str, ...] = ("t", "x", "y")
    # 'channel' | 'token' | 'group' gate granularity.
    granularity: str = "channel"
    window: int = 2
    # Eq. 4 schedule: steps < i_min and the final step run dense; linear
    # ramp theta_min -> theta_max on [i_min, i_max]; plateau after.
    theta_min: float = 0.2
    theta_max: float = 0.5
    i_min: int = 10
    i_max: int = 20
    fixed_threshold: Optional[float] = None
    theta_t: Optional[float] = None
    theta_x: Optional[float] = None
    theta_y: Optional[float] = None
    # RoPE channel-group split (t, x, y) as fractions of head_dim.
    channel_groups: Tuple[float, float, float] = (0.125, 0.4375, 0.4375)
    snap_q: bool = True
    snap_k: bool = True
    svg_mask: bool = False
    svg_keep_ratio: float = 0.3
    execution: str = "reference"  # 'reference' | 'collapse'
    policy: str = "ripple"
    # 'auto' | 'dense' | 'reference' | 'collapse' | 'pallas' | 'sparse'.
    # In the port 'pallas' names the hand-written CUDA ripple kernel and
    # 'sparse' the hand-written CUDA block-sparse kernel.
    backend: str = "auto"
    # 'auto' uses the fused CUDA Δ-check kernel on CUDA operands; 'on'
    # forces the fused wrapper (its plain version on CPU tensors); 'off'
    # keeps the host pipeline of ``core.reuse``.
    fused_mask: str = "auto"
    reuse_every: int = 1
    drift_tol: float = 0.0
    drift_channels: int = 8
    sentinel: bool = False
    sentinel_probe_every: int = 0
    enable_1d: bool = False

    def active(self) -> bool:
        return self.enabled


@dataclass(frozen=True)
class VDiTConfig:
    """The paper's native setting: a video DiT with (t, x, y) token grid
    and factorized RoPE channel groups."""

    frames: int
    img_res: int
    patch: int
    t_patch: int
    num_layers: int
    d_model: int
    num_heads: int
    in_channels: int = 16
    vae_factor: int = 8
    t_vae_factor: int = 4
    mlp_ratio: float = 4.0
    txt_tokens: int = 256
    txt_dim: int = 4096
    axes_dim: Tuple[int, ...] = (16, 56, 56)

    def grid(self, frames=None, img_res=None) -> Tuple[int, int, int]:
        t = (frames or self.frames) // self.t_vae_factor // self.t_patch
        s = (img_res or self.img_res) // self.vae_factor // self.patch
        return (max(t, 1), s, s)


@dataclass(frozen=True)
class DiTConfig:
    """Image diffusion transformer (DiT, arXiv:2212.09748)."""

    img_res: int
    patch: int
    num_layers: int
    d_model: int
    num_heads: int
    in_channels: int = 4  # VAE latent channels
    vae_factor: int = 8
    num_classes: int = 1000
    mlp_ratio: float = 4.0
    learn_sigma: bool = True

    def latent_res(self, img_res: Optional[int] = None) -> int:
        return (img_res or self.img_res) // self.vae_factor

    def num_tokens(self, img_res: Optional[int] = None) -> int:
        side = self.latent_res(img_res) // self.patch
        return side * side


@dataclass(frozen=True)
class ShapeSpec:
    """One workload cell: (architecture x input shape)."""

    name: str
    kind: str
    seq_len: int = 0
    global_batch: int = 0
    img_res: int = 0
    batch: int = 0
    steps: int = 0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    model: Any
    shapes: Tuple[ShapeSpec, ...]
    ripple: RippleConfig = field(default_factory=RippleConfig)
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name}: unknown shape {name!r}; have "
                       f"{[s.name for s in self.shapes]}")


def _coerce(value: str, target: Any) -> Any:
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        items = [v for v in value.split(",") if v]
        if target and isinstance(target[0], (int, float)):
            cast = type(target[0])
            return tuple(cast(v) for v in items)
        return tuple(items)
    return value


def apply_overrides(cfg, overrides):
    """Apply ``a.b.c=value`` override strings to a nested dataclass."""
    for item in overrides:
        key, _, raw = item.partition("=")
        cfg = _apply_one(cfg, key.split("."), raw)
    return cfg


def _apply_one(cfg, parts, raw):
    if len(parts) == 1:
        current = getattr(cfg, parts[0])
        return replace(cfg, **{parts[0]: _coerce(raw, current)})
    child = getattr(cfg, parts[0])
    if not dataclasses.is_dataclass(child):
        raise TypeError(f"cannot descend into non-dataclass field {parts[0]}")
    return replace(cfg, **{parts[0]: _apply_one(child, parts[1:], raw)})

"""Typed configuration for the PyTorch port.

The port keeps its own copy of the dataclasses it needs, with the same
field names and defaults as the JAX package's ``repro.config.base``, so
that one config (and one ``key=value`` override string) means the same
thing in both packages.  The vDiT, DiT, MMDiT, UNet, ViT, EfficientNet
and LM (dense and MoE) families are carried over, with the training
(``TrainConfig``) and checkpoint (``CheckpointConfig``) settings.
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
    it).  ``reuse_every`` / ``drift_tol`` / ``drift_channels`` drive the
    cross-step decision cache (``core.decision_cache``).  ``sentinel``
    folds the guardrail sentinels into that cache's state (the non-finite
    count of each attention output) and ``sentinel_probe_every`` K adds a
    dense float32 probe of one (batch, head) slice every K steps
    (``core.guardrail``).  ``enable_1d`` (1-D reuse) is not acted on and
    keeps its default so configs stay interchangeable.
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
class MMDiTConfig:
    """Flux-style MMDiT: double-stream joint blocks + single-stream blocks."""

    img_res: int
    latent_res: int
    n_double_blocks: int
    n_single_blocks: int
    d_model: int
    num_heads: int
    in_channels: int = 16
    patch: int = 2
    txt_tokens: int = 512
    txt_dim: int = 4096
    mlp_ratio: float = 4.0
    axes_dim: Tuple[int, ...] = (16, 56, 56)  # RoPE split (t/ids, x, y)


@dataclass(frozen=True)
class UNetConfig:
    """SD1.5-style latent UNet (arXiv:2112.10752)."""

    img_res: int
    latent_res: int
    ch: int
    ch_mult: Tuple[int, ...]
    n_res_blocks: int
    attn_res: Tuple[int, ...]  # downsample factors at which attention runs
    ctx_dim: int
    in_channels: int = 4
    num_heads: int = 8
    ctx_tokens: int = 77


@dataclass(frozen=True)
class ViTConfig:
    img_res: int
    patch: int
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    num_classes: int = 1000
    in_channels: int = 3
    pool: str = "cls"  # 'cls' | 'gap'


@dataclass(frozen=True)
class EffNetConfig:
    img_res: int
    width_mult: float
    depth_mult: float
    num_classes: int = 1000
    dropout: float = 0.5
    in_channels: int = 3


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 2
    expert_ffw_dim: int = 0
    # Token-capacity factor for fixed-shape dispatch at scale.
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer LM (dense or MoE)."""

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # Sliding-window attention: window size for local layers, and the
    # local:global interleave pattern (gemma3: 5 local then 1 global).
    sliding_window: int = 0
    local_global_pattern: int = 0  # N -> every (N+1)th layer is global
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


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
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"  # 'cosine' | 'linear' | 'constant'
    grad_accum: int = 1
    ema_decay: float = 0.0  # 0 disables EMA
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # 'full' | 'dots' (the LM family's; not acted on by the port yet).
    remat_policy: str = "full"
    # Mesh settings of the reference, kept so configs stay
    # interchangeable: the port trains on one card.
    seq_parallel: bool = False
    grad_compression: bool = False


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "/tmp/repro_ckpt"
    interval_steps: int = 100
    keep: int = 3
    async_save: bool = True


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    model: Any
    shapes: Tuple[ShapeSpec, ...]
    ripple: RippleConfig = field(default_factory=RippleConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    source: str = ""
    # decode-time sharding: replicate the q-heads so the KV cache's
    # sequence dim owns the model axis without resharding.
    decode_replicate_heads: bool = False
    # decode-time weights: plain tensor parallelism (replicated over the
    # batch axes) instead of FSDP.
    decode_no_fsdp: bool = False

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

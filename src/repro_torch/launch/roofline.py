"""Roofline terms of the port on one NVIDIA H100, the counterpart of the
JAX package's ``launch/roofline.py`` (whose constants are a TPU v5e's).

Three terms per (arch x shape x ranks), in seconds, for one rank:

    compute    = FLOPs / 989e12 FLOP/s (bf16 dense)  + each kernel's
                 operations at the peak of their type
    memory     = bytes / 3.35e12 B/s (HBM3)
    collective = bytes on the wire / 450e9 B/s (NVLink 4, one direction)

The counts come from ``launch.dryrun``, which runs one rank's step on
fake tensors: FLOPs from ``torch.utils.flop_counter.FlopCounterMode``,
bytes as the inputs and outputs of each ATen op (eager PyTorch fuses
nothing), each hand-written kernel's operations and bytes from the
formulas below (the ones ``chip_smoke.py`` bounds each kernel with, so
each kernel has one count), and the collectives that
``distributed/fsdp.py`` calls.  Every ATen FLOP is put at the bf16
tensor-core peak, the reference's single peak: where a GEMM runs in
float32 the term is lower than its time can be, so it stays a bound.
The memory term puts every byte through HBM; an op that finds its
operands in the 50 MB L2 cache moves fewer, so on small activations the
term is an estimate rather than a floor.

Also reported: MODEL_FLOPS = 6·N·D (a trained token) or 2·N·D (an
inferred one), N the active parameters for a MoE, and the useful ratio
MODEL_FLOPS / counted FLOPs that exposes remat's recomputation.

The reference's ``collective_bytes_from_hlo`` and ``analyze(compiled,
hlo_text, ...)`` parse XLA's compiled artifacts (cost analysis and HLO
text); the port compiles nothing, so they have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import ArchConfig, LMConfig, ShapeSpec

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W power limit):
# device memory and arithmetic, and the memory's size (80 GB: five 16 GiB
# HBM3 stacks, of which the driver keeps some).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES = 80 * 2**30
# NVLink 4 on the H100 SXM: 18 links, 900 GB/s both directions together
# (NVIDIA's data sheet), so 450e9 B/s leave a card in one direction; a
# ring collective's bytes on the wire go at that rate.
NVLINK_BYTES_PER_S = 450e9
# Exponentials: 16 ex2 results a clock per SM on the special-function
# units, at the clock that gives the data-sheet bf16 peak (4096 dense
# FLOP a clock per SM on 132 SMs: 1.83 GHz), 3.86e12 a second.  It counts
# neither exponentials evaluated as polynomials on the FMA pipes nor
# boost clocks above 1.83 GHz, so it is an estimate, not a strict floor.
SM_COUNT = 132
CLOCK_HZ = PEAK_FLOPS["bfloat16"] / (SM_COUNT * 4096)
EXP2_PER_S = SM_COUNT * 16 * CLOCK_HZ
# Float ops per element of the Δ-check: three window-2 Δ (9 ops each,
# shared by 2 elements), three compares, the first-wins select chain.
REUSE_OPS_PER_ELEM = 3 * 9 / 2 + 3 + 3


# --- the hand-written kernels' work -----------------------------------------

class KernelWork(NamedTuple):
    """One kernel call's work: ``ops`` at the peak of ``ops_dtype``,
    ``exps`` exponentials on the special-function units, ``nbytes``
    read and written once."""

    ops: float
    ops_dtype: str
    nbytes: float
    exps: float = 0.0

    def terms(self) -> Dict[str, float]:
        """Seconds by what bounds them: bytes, operations (and
        exponentials where there are any)."""
        t = {"bytes": self.nbytes / HBM_BYTES_PER_S,
             "operations": self.ops / PEAK_FLOPS[self.ops_dtype]}
        if self.exps:
            t["exponentials"] = self.exps / EXP2_PER_S
        return t

    def bound(self) -> Tuple[float, str]:
        """(bound ms, what bounds it): the largest term; a tie goes to
        bytes."""
        t = self.terms()
        by = max(t, key=t.get)
        return t[by] * 1e3, by


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def reuse_work(shape: Sequence[int], elt: int, grid: Sequence[int],
               want_src: bool = False) -> KernelWork:
    """One fused_reuse call on a (..., N, d) operand of ``elt``-byte
    elements over a (T, H, W) grid: every element read once and written
    once with its mask byte, over the whole sequence, plus 4 bytes of
    source map a grid element with ``want_src``; the Δ arithmetic on the
    grid elements at the float32 peak."""
    numel = math.prod(shape)
    n_grid = numel // shape[-2] * grid[0] * grid[1] * grid[2]
    nbytes = numel * (2 * elt + 1) + (4 * n_grid if want_src else 0)
    return KernelWork(n_grid * REUSE_OPS_PER_ELEM, "float32", nbytes)


def ripple_work(shape: Sequence[int], dv: int, elt: int,
                flops: Optional[float] = None) -> KernelWork:
    """One ripple call on (B, H, N, d) operands: the score and PV products
    (``flops``: what the operands' collapsed tiles leave,
    ``kernels.ripple.ops.ripple_tile_stats``; None: nothing collapsed,
    2·N²·(d + dv) a row of B·H) at the bf16 tensor peak, one exponential
    a score, and q, k, v read and the output written once."""
    B, H, N, d = shape
    if flops is None:
        flops = 2.0 * B * H * N * N * (d + dv)
    numel = B * H * N * d
    nbytes = (3 * numel + numel // d * dv) * elt
    return KernelWork(flops, "bfloat16", nbytes, flops / (2 * (d + dv)))


def sparse_areas(block_map: torch.Tensor, q_shape: Sequence[int], nk: int,
                 blk: int, bias_shape: Optional[Sequence[int]] = None
                 ) -> Tuple[float, float, int]:
    """(score elements in non-SKIP tiles, bias elements the kernel reads,
    block-map entries) of one sparse call with this (..., nq, nk) map:
    the bias is read once, so a slab broadcast over batch rows or heads
    counts the tiles that are PARTIAL in any map that reads it."""
    from repro_torch.kernels.sparse.ref import PARTIAL, SKIP, sparse_grid

    B, H, Nq, _ = q_shape
    bq, bk, nq, nkb = sparse_grid(Nq, nk, blk, blk)
    rows = torch.tensor([min(bq, Nq - i * bq) for i in range(nq)],
                        dtype=torch.float64)
    keys = torch.tensor([min(bk, nk - j * bk) for j in range(nkb)],
                        dtype=torch.float64)
    area = rows[:, None] * keys[None, :]
    bm = block_map.expand(B, H, nq, nkb).cpu()
    live = ((bm != SKIP).double() * area).sum().item()
    pm = bm == PARTIAL
    if bias_shape is not None:
        for dim in (0, 1):
            if bias_shape[dim] == 1:
                pm = pm.any(dim, keepdim=True)
    partial = (pm.double() * area).sum().item()
    return live, partial, bm.numel()


def sparse_work(q_shape: Sequence[int], nk: int, dv: int, dtype, blk: int,
                *, live: Optional[float] = None,
                partial: Optional[float] = None,
                map_numel: Optional[int] = None,
                bias_shape: Optional[Sequence[int]] = None) -> KernelWork:
    """One sparse call on (B, H, Nq, d) queries against ``nk`` keys: the
    products of the non-SKIP tiles (2·(d + dv) flops a score) at the
    peak of the operands' dtype, q, k, v and the output once, the int32
    map, and the float32 bias of the PARTIAL tiles.  ``live``,
    ``partial`` and ``map_numel`` come from :func:`sparse_areas` on a
    real map; None counts with nothing skipped: every tile live, every
    tile of the bias's slab read, a (B, H, nq, nk) map."""
    from repro_torch.kernels.sparse.ref import sparse_grid

    B, H, Nq, d = q_shape
    _, _, nq, nkb = sparse_grid(Nq, nk, blk, blk)
    if live is None:
        live = float(B * H * Nq * nk)
    if map_numel is None:
        map_numel = B * H * nq * nkb
    if partial is None:
        partial = 0.0 if bias_shape is None else float(
            bias_shape[0] * bias_shape[1] * Nq * nk)
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = (elt * (B * H * (Nq * d + nk * d + nk * dv + Nq * dv))
              + 4 * map_numel + (4 * partial if bias_shape is not None
                                 else 0))
    return KernelWork(2.0 * (d + dv) * live, _dtype_name(dtype), nbytes)


def flash_work(B: int, H: int, Nq: int, Nk: int, d: int, dv: int,
               dtype_name: str) -> KernelWork:
    """One dense flash call: 2·Nq·Nk·(d + dv) flops a (batch, head) at
    the dtype's peak; q, k, v and the output once."""
    flops = 2.0 * B * H * Nq * Nk * (d + dv)
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = elt * B * H * (Nq * d + Nk * d + Nk * dv + Nq * dv)
    return KernelWork(flops, dtype_name, nbytes)


def snap_work(shape: Sequence[int], elt: int) -> KernelWork:
    """One reuse_snap call: the operand read, the snapped copy and its
    int8 mask written; sub, abs, mul and compare a pair-channel at the
    float32 peak."""
    numel = math.prod(shape)
    return KernelWork(4 * numel / 2, "float32", numel * (2 * elt + 1))


def adaln_work(shape: Sequence[int], elt: int) -> KernelWork:
    """One adaLN call on x (B, N, d): x read and the output written, the
    (B, d) shift and scale read; 10 float ops an element (mean, variance,
    normalise, modulate) at the float32 peak."""
    B, N, d = shape
    numel = B * N * d
    return KernelWork(10 * numel, "float32", 2 * numel * elt + 2 * B * d * elt)


# --- the reference's report ---------------------------------------------------

@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # one rank's counted FLOPs (name kept)
    hlo_bytes: float            # one rank's counted bytes (name kept)
    collective_bytes: float     # one rank's bytes on the wire
    collective_breakdown: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    steps_multiplier: int = 1
    peak_mem_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        global_flops = self.hlo_flops * self.chips
        return self.model_flops / global_flops if global_flops else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_ratio,
            "peak_mem_gb": self.peak_mem_bytes / 1e9,
        }


def model_flops_estimate(arch: ArchConfig, shape: ShapeSpec,
                         param_count: int, active_param_count: int) -> float:
    """6·N·D per trained token (fwd+bwd); 2·N·D per inference token."""
    if shape.kind == "train":
        if arch.family == "lm":
            tokens = shape.global_batch * shape.seq_len
        else:
            tokens = _vision_tokens(arch, shape) * shape.batch
        return 6.0 * active_param_count * tokens
    if arch.family == "lm":
        if shape.kind == "prefill":
            tokens = shape.global_batch * shape.seq_len
        else:  # decode: one new token per sequence
            tokens = shape.global_batch * 1
        return 2.0 * active_param_count * tokens
    from repro_torch.launch.workloads import _cfg_factor

    tokens = _vision_tokens(arch, shape) * shape.batch
    f = _cfg_factor(arch) if shape.kind == "generate" else 1
    return 2.0 * active_param_count * tokens * f


def _vision_tokens(arch: ArchConfig, shape: ShapeSpec) -> int:
    m = arch.model
    fam = arch.family
    res = shape.img_res
    if fam == "dit":
        return (res // m.vae_factor // m.patch) ** 2
    if fam == "mmdit":
        return (res // 8 // m.patch) ** 2 + m.txt_tokens
    if fam == "unet":
        return (res // 8) ** 2           # dominated by the top level
    if fam == "vdit":
        g = m.grid(img_res=res)
        return g[0] * g[1] * g[2] + m.txt_tokens
    if fam == "vit":
        return (res // m.patch) ** 2 + 1
    if fam == "effnet":
        return (res // 32) ** 2          # proxy: bottleneck grid
    raise ValueError(fam)


def analyze_values(flops: float, byts: float, coll: Dict[str, int],
                   arch: ArchConfig, shape: ShapeSpec, mesh_desc: str,
                   chips: int, param_count: int,
                   active_param_count: Optional[int] = None,
                   steps_multiplier: int = 1,
                   kernel_s: float = 0.0) -> RooflineReport:
    """Roofline report from one rank's counts: ``flops`` of ATen ops at
    the bf16 peak plus ``kernel_s``, the hand-written kernels' operations
    at their own peaks; ``byts`` at the HBM rate; ``coll``
    (bytes on the wire by collective) at NVLink's."""
    coll_total = float(sum(coll.values()))
    mf = model_flops_estimate(arch, shape, param_count,
                              active_param_count or param_count)
    return RooflineReport(
        arch=arch.name, shape=shape.name, mesh=mesh_desc, chips=chips,
        hlo_flops=flops, hlo_bytes=byts,
        collective_bytes=coll_total, collective_breakdown=coll,
        compute_s=flops / PEAK_FLOPS["bfloat16"] + kernel_s,
        memory_s=byts / HBM_BYTES_PER_S,
        collective_s=coll_total / NVLINK_BYTES_PER_S,
        model_flops=mf, steps_multiplier=steps_multiplier)


def param_count(cfg) -> int:
    """Parameters of a model config's family, counted on a model made on
    the meta device (no memory)."""
    from repro_torch.models.params import _family

    cls, _ = _family(cfg)
    model = cls(cfg, device=torch.device("meta"), dtype=torch.float32)
    return sum(p.numel() for p in model.parameters())


def active_params_lm(cfg: LMConfig) -> int:
    """Active (per-token) parameter count for MoE LMs."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    routed = 3 * m.num_experts * cfg.d_model * m.expert_ffw_dim \
        * cfg.num_layers
    active_routed = routed * m.top_k / m.num_experts
    return int(total - routed + active_routed)

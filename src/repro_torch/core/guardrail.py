"""Runtime quality guardrails (DESIGN.md §17), on torch tensors.

Two halves, as in the JAX package:

**Sentinels** (device-side, read by the engine once a batch):

  * non-finite detection: an ``isfinite`` count over the attention output
    of each cached dispatch call, accumulated into
    :attr:`~repro_torch.core.decision_cache.CachedDecision.nonfinite`, and
    over the latents after each denoising step (the samplers'
    ``sentinel`` flag).  Both stay device tensors: nothing here reads the
    device, so a sentinel adds no host sync to a step or a layer.
  * a sampled drift proxy: every ``cfg.sentinel_probe_every`` steps the
    leading (batch, head) slice of the output is recomputed densely in
    float32 (plain ``torch.matmul`` / softmax, outside any kernel) and the
    relative L2 error is max-accumulated into ``CachedDecision.probe_err``.
    The step is a host integer, so whether a probe is due is decided on
    the host.

**The degradation ladder** (:class:`DegradationLadder`, pure Python): the
engine reads the sentinels after every batch and, on a trip, steps the
bucket's policy down one rung (``rainfusion`` / ``static`` / ``svg`` /
``equal_mse`` -> ``ripple`` -> ``dense``) and serves the batch again
under the degraded bucket key.  Degradation is sticky with a cool-down:
after ``cooldown_batches`` clean batches one batch probes the original
policy again.  The ladder keys on the bucket family (the key without its
policy and pattern token); one ladder shared by router replicas keeps its
state across a failover.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Hashable, List, Mapping, Optional, Tuple

import torch

__all__ = ["DEGRADATION_LADDER", "DegradationLadder", "GuardrailConfig",
           "attach_sentinel", "dense_probe_error", "next_policy",
           "nonfinite_count"]


# ---------------------------------------------------------------------------
# Sentinels
# ---------------------------------------------------------------------------


def nonfinite_count(x: torch.Tensor,
                    lead_ndim: Optional[int] = None) -> torch.Tensor:
    """int32 count of the non-finite entries of ``x``: per leading cell
    with ``lead_ndim`` (the decision-cache leaf shape), else in total."""
    bad = ~torch.isfinite(x)
    if lead_ndim is None:
        return bad.sum().to(torch.int32)
    dims = tuple(range(lead_ndim, x.ndim))
    if not dims:
        return bad.to(torch.int32)
    return bad.sum(dim=dims).to(torch.int32)


def dense_probe_error(q, k, v, out, scale) -> torch.Tensor:
    """Relative L2 error of one (N, d) attention slice ``out`` against its
    dense float32 recompute; a NaN anywhere propagates into it."""
    q32, k32, v32 = (a.float() for a in (q, k, v))
    logits = torch.matmul(q32, k32.transpose(-1, -2)) * float(scale)
    ref = torch.matmul(torch.softmax(logits, dim=-1), v32)
    diff = torch.linalg.vector_norm(ref - out.float())
    return diff / (torch.linalg.vector_norm(ref) + 1e-6)


def attach_sentinel(cache, out, q, k, v, scale, step, cfg):
    """Fold this dispatch call's readings into the decision-cache state:
    add the non-finite count of ``out`` per (batch, head) cell and, when
    ``step`` is on the ``cfg.sentinel_probe_every`` cadence, max the dense
    probe error of the leading slice into ``probe_err``."""
    lead = tuple(out.shape[:-2])
    nf = nonfinite_count(out, lead_ndim=len(lead))
    if cache.nonfinite is not None:
        nf = cache.nonfinite + nf
    pe = cache.probe_err if cache.probe_err is not None else torch.zeros(
        lead, dtype=torch.float32, device=out.device)
    every = int(cfg.sentinel_probe_every)
    if every > 0 and step is not None and int(step) % every == 0:
        idx = (0,) * len(lead)
        err = dense_probe_error(q[idx], k[idx], v[idx], out[idx], scale)
        pe = pe.clone()
        pe[idx] = torch.maximum(pe[idx], err)
    return dataclasses.replace(cache, nonfinite=nf, probe_err=pe)


# ---------------------------------------------------------------------------
# The degradation ladder
# ---------------------------------------------------------------------------

# One rung down per trip; unknown policies and the default None go
# straight to dense, the floor.
DEGRADATION_LADDER: Mapping[str, str] = {
    "rainfusion": "ripple",
    "static": "ripple",
    "svg": "ripple",
    "equal_mse": "ripple",
    "ripple": "dense",
}


def next_policy(policy: Optional[str]) -> Optional[str]:
    """The rung below ``policy`` (None at the dense floor)."""
    if policy == "dense":
        return None
    return DEGRADATION_LADDER.get(policy, "dense")


def _chain(base: Optional[str]) -> List[Optional[str]]:
    chain: List[Optional[str]] = [base]
    cur = base
    while True:
        nxt = next_policy(cur)
        if nxt is None:
            return chain
        chain.append(nxt)
        cur = nxt


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    """Trip thresholds and stickiness of the ladder."""

    # Non-finite entries tolerated per batch (latents and attention
    # sentinels together); 0: any NaN trips.
    max_nonfinite: int = 0
    # Dense-probe relative error that trips; 0 keeps the probe a
    # diagnostic.  A non-finite probe always trips.
    drift_tol: float = 0.0
    # Clean batches at a degraded rung before one batch probes the base
    # policy again.
    cooldown_batches: int = 8


@dataclasses.dataclass
class _Health:
    level: int = 0        # rungs below the base policy
    clean: int = 0        # clean batches at the current rung
    probing: bool = False  # the next batch probes the base policy


class DegradationLadder:
    """Per-bucket-family degradation state (thread-safe; share one across
    router replicas).  The engine calls :meth:`effective_policy` before a
    batch, :meth:`trip` when a sentinel fires, :meth:`record_clean`
    otherwise."""

    def __init__(self, config: Optional[GuardrailConfig] = None):
        self.config = config or GuardrailConfig()
        self._state: Dict[Hashable, _Health] = {}
        self._lock = threading.Lock()
        self.degraded_count = 0    # rungs stepped down
        self.dense_fallbacks = 0   # trips that landed on dense
        self.repromotions = 0      # probes that restored the base policy
        self.failed_probes = 0     # probes that tripped again

    def effective_policy(self, family: Hashable, base: Optional[str]
                         ) -> Tuple[Optional[str], bool]:
        """(policy to serve this batch under, is it a re-promotion
        probe)."""
        with self._lock:
            h = self._state.get(family)
            if h is None or h.level == 0:
                return base, False
            if h.probing:
                return base, True
            if h.clean >= self.config.cooldown_batches:
                h.probing = True
                return base, True
            chain = _chain(base)
            return chain[min(h.level, len(chain) - 1)], False

    def trip(self, family: Hashable, base: Optional[str]) -> Optional[str]:
        """A sentinel fired: the policy to serve the batch again under, or
        None at the dense floor (the engine then errors the batch)."""
        chain = _chain(base)
        with self._lock:
            h = self._state.setdefault(family, _Health())
            if h.probing:
                # The probe of the base policy tripped: back to the parked
                # rung, and the cool-down starts again.
                h.probing = False
                h.clean = 0
                self.failed_probes += 1
                return chain[min(h.level, len(chain) - 1)]
            if h.level + 1 >= len(chain):
                return None
            h.level += 1
            h.clean = 0
            self.degraded_count += 1
            pol = chain[h.level]
            if pol == "dense":
                self.dense_fallbacks += 1
            return pol

    def record_clean(self, family: Hashable) -> None:
        """A batch served without a trip: advance the cool-down, or
        restore the base policy after a clean probe."""
        with self._lock:
            h = self._state.get(family)
            if h is None or h.level == 0:
                return
            if h.probing:
                h.level = 0
                h.probing = False
                h.clean = 0
                self.repromotions += 1
            else:
                h.clean += 1

    def degraded(self, family: Hashable) -> bool:
        with self._lock:
            h = self._state.get(family)
            return h is not None and h.level > 0

    def metrics(self) -> Dict[str, int]:
        with self._lock:
            return {"degraded_count": self.degraded_count,
                    "dense_fallbacks": self.dense_fallbacks,
                    "repromotions": self.repromotions,
                    "failed_probes": self.failed_probes,
                    "degraded_buckets": sum(
                        1 for h in self._state.values() if h.level > 0)}

"""SLO primitives for the serving engine (DESIGN.md §15).

The scheduling problem TimeRipple leaves behind: once the per-step
attention cost drops ~85% (PAPER.md Tbl. 2), end-to-end latency under
real traffic is dominated by *queueing*, not compute.  This module holds
the pieces the :class:`~repro_torch.serving.engine.DiffusionEngine` composes
into deadline-aware serving:

  * :class:`ServiceEstimator` — per-bucket batch service-time tracking.
    Two statistics per bucket: an optimistic **lower bound** (the
    fastest batch ever observed) used for *provable* admission
    decisions, and an **EWMA** used for feasibility ranking inside the
    scheduler.  A bucket with no observation yet has no bound — the
    engine then admits (never shed on a guess).
  * :func:`admission_decision` — shed-at-the-door check: a request is
    rejected only when it *provably* cannot meet its deadline, i.e. its
    deadline already passed, or the optimistic lower bound on draining
    the requests already ahead of it in its own bucket (FIFO within a
    bucket) plus its own batch exceeds the deadline.  Conservative by
    construction: sheds only what hottest-first or EDF could not have
    saved either.
  * :func:`choose_bucket` — the drain policy.  Starvation aging first
    (a head request older than ``starve_after_s`` always wins, exactly
    as before this seam existed); then, under the ``"edf"`` scheduler,
    earliest-feasible-deadline among buckets whose head carries a
    deadline (falling back to earliest-even-if-infeasible so a late
    request is still served, just not at the cost of feasible ones);
    deadline-less traffic — and the ``"hottest"`` scheduler — drain
    hottest (deepest) bucket first.

Deadlines are absolute ``time.time()`` seconds on
:attr:`~repro_torch.serving.engine.GenRequest.deadline_s`; callers that
think in relative SLOs stamp ``time.time() + slo_ms / 1e3`` at submit.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Hashable, Mapping, Optional, Sequence, Tuple

__all__ = ["ShedError", "ServiceEstimator", "admission_decision",
           "choose_bucket"]


class ShedError(RuntimeError):
    """Raised by ``submit`` when admission control proves the request
    cannot meet its deadline under the current queue depth.  Shed at
    the door: no compute was spent, no result record exists."""


class ServiceEstimator:
    """Per-bucket batch service-time statistics (thread-safe).

    ``observe`` is called by the engine after every served batch;
    ``lower_bound`` is the fastest observation (the provable-admission
    bound), ``expected`` an EWMA (the scheduling estimate).  Unknown
    buckets return ``None`` for both — callers must treat that as
    "cannot prove anything".
    """

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._min: Dict[Hashable, float] = {}
        self._ewma: Dict[Hashable, float] = {}
        self._lock = threading.Lock()

    def observe(self, key: Hashable, seconds: float) -> None:
        with self._lock:
            prev = self._min.get(key)
            self._min[key] = seconds if prev is None else min(prev, seconds)
            ew = self._ewma.get(key)
            self._ewma[key] = seconds if ew is None else (
                self.alpha * seconds + (1.0 - self.alpha) * ew)

    def lower_bound(self, key: Hashable) -> Optional[float]:
        with self._lock:
            return self._min.get(key)

    def expected(self, key: Hashable) -> Optional[float]:
        with self._lock:
            return self._ewma.get(key)

    def timeout_hint(self, key: Hashable, floor_s: float,
                     mult: float = 8.0) -> float:
        """Watchdog budget for one batch of ``key`` (DESIGN.md §17.4):
        ``mult`` × the EWMA service time once observed, never below
        ``floor_s`` — so the hang detector scales with what the bucket
        actually costs (first-batch compiles included in the EWMA)
        instead of a blind constant, and an unobserved bucket gets the
        caller's floor rather than a guess of zero."""
        est = self.expected(key)
        if est is None:
            return floor_s
        return max(floor_s, mult * est)

    # -- warm-restart persistence (DESIGN.md §18) --------------------------

    def to_json(self) -> str:
        """Serialize the per-bucket statistics.  Keys are stored as
        ``repr`` strings — bucket keys are tuples of ints/strings/None,
        which round-trip exactly through ``ast.literal_eval``."""
        import json

        with self._lock:
            return json.dumps({
                "alpha": self.alpha,
                "min": {repr(k): v for k, v in self._min.items()},
                "ewma": {repr(k): v for k, v in self._ewma.items()},
            })

    @classmethod
    def from_json(cls, text: str) -> "ServiceEstimator":
        """Rebuild an estimator from :meth:`to_json` output, so a warm
        restart keeps its admission bounds and watchdog budgets instead
        of re-learning them (and re-admitting provably-infeasible
        traffic) from scratch.  Unparseable keys are skipped, not
        fatal — stale persisted state must never block a restart."""
        import ast
        import json

        d = json.loads(text)
        est = cls(alpha=float(d.get("alpha", 0.3)))
        for attr, src in (("_min", d.get("min", {})),
                          ("_ewma", d.get("ewma", {}))):
            out = getattr(est, attr)
            for ks, v in src.items():
                try:
                    out[ast.literal_eval(ks)] = float(v)
                except (ValueError, SyntaxError):
                    continue
        return est


def _batches_needed(queued_ahead: int, max_batch: int) -> int:
    """Minimum sampler invocations before a request joining a bucket
    with ``queued_ahead`` requests ahead of it comes back (FIFO within
    the bucket, batches of at most ``max_batch``)."""
    return int(math.ceil((queued_ahead + 1) / max(max_batch, 1)))


def admission_decision(deadline_s: Optional[float], now: float,
                       queued_ahead: int, max_batch: int,
                       lower_bound_s: Optional[float]) -> Optional[str]:
    """``None`` to admit, else a human-readable shed reason.

    Sheds only on proof: the deadline already passed, or even the
    fastest-ever batch time for this bucket cannot drain the FIFO ahead
    of the request plus the request itself before the deadline.
    """
    if deadline_s is None:
        return None
    if deadline_s <= now:
        return f"deadline passed {now - deadline_s:.3f}s before submit"
    if lower_bound_s is None:
        return None  # no observation yet: cannot prove infeasibility
    need = _batches_needed(queued_ahead, max_batch) * lower_bound_s
    if now + need > deadline_s:
        return (f"needs >= {need:.3f}s ({queued_ahead} ahead, "
                f"best batch {lower_bound_s:.3f}s) but only "
                f"{deadline_s - now:.3f}s of budget remains")
    return None


# head of each live bucket: (enqueue_time, deadline_s or None, depth)
HeadInfo = Tuple[float, Optional[float], int]


def choose_bucket(heads: Mapping[Hashable, HeadInfo], now: float, *,
                  scheduler: str = "edf", starve_after_s: float = 2.0,
                  estimator: Optional[ServiceEstimator] = None):
    """Pick the next bucket to drain (``None`` if ``heads`` is empty).

    Aging first: the oldest head past ``starve_after_s`` wins
    unconditionally, so deadline-less (or far-deadline) traffic is
    never starved by a stream of tight SLOs — the same guard the
    hottest-first engine shipped with.  Then EDF over deadline-carrying
    heads, preferring feasible ones (``now + expected <= deadline``;
    heads in buckets without an estimate count as feasible); if every
    deadline is already infeasible, the earliest still goes first —
    late is better than later.  Buckets without any deadline at the
    head, or the ``"hottest"`` scheduler, drain deepest-first.
    """
    if not heads:
        return None
    oldest = min(heads, key=lambda k: heads[k][0])
    if now - heads[oldest][0] > starve_after_s:
        return oldest
    if scheduler == "edf":
        with_dl = {k: v[1] for k, v in heads.items() if v[1] is not None}
        if with_dl:
            def feasible(k):
                est = estimator.expected(k) if estimator is not None else None
                return est is None or now + est <= with_dl[k]
            pool = {k: d for k, d in with_dl.items() if feasible(k)}
            if not pool:
                pool = with_dl
            return min(pool, key=pool.get)
    return max(heads, key=lambda k: heads[k][2])

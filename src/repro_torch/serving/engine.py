"""Serving engines: shape-bucketed continuous batching for video and
image generation, with deadline-aware scheduling, admission control and
the guardrail escalation chain (:class:`DiffusionEngine`), and prefill +
decode for the LM family (:class:`LMEngine`).

Requests are keyed into a **bucket** by the reference's 9-tuple
``(latent_shape, steps, policy, reuse_every, seq_shards, txt_shape,
stream_every, pattern_token, resume_step)``, so one sampler invocation
never pads or mixes shapes, reuse policies, decision-cache cadences,
streaming cadences or resume points.  ``seq_shards`` is the ``seq``
degree of the active dispatch mesh (1 without one: :func:`_seq_shards`).
``resume_step`` is 0 for fresh traffic
and the checkpoint's step for a request resuming mid-flight: batchmates
share one step range, but the sampler LRU is keyed on ``key[:8]``, so a
resumed request runs on its fresh bucket's sampler.  The pattern token
is the bucket policy's ``plan_token`` (the pattern artifact's version),
fixed at submit together with the policy the sampler runs: a pattern
policy is pinned there to the artifact active then, and that pinned
policy travels with the request to the factory, so the sampler built for
a key (also after an eviction) runs on the artifact the key names, and
traffic after an artifact swap gets a sampler of its own.

A worker thread drains the buckets under the SLO-aware order of
:func:`repro_torch.serving.slo.choose_bucket` (DESIGN.md §15): a head
older than ``starve_after_s`` first, then under the ``edf`` scheduler the
earliest feasible deadline among heads that carry one, then the deepest
bucket (ties to the first bucket created).  It lingers ``max_wait_s``
for batch-mates from the same bucket up to ``max_batch`` and runs that
bucket's sampler, held in a bounded LRU (keyed on ``key[:8]``) of
``sampler_factory(latent_shape, steps[, policy[, reuse_every[,
stream_every]]])`` results; ``plan_fn`` lets the launcher log each
bucket's attention plan when its sampler is built.  Admission control
sheds a request at submit (:class:`~repro_torch.serving.slo.ShedError`)
only when its deadline provably cannot be met
(:func:`~repro_torch.serving.slo.admission_decision`).

Streaming: a factory that honours ``stream_every`` returns a *generator*
sampler yielding the latents every K denoising steps; the engine
publishes each chunk to :meth:`DiffusionEngine.stream` subscribers as it
lands and records the time to the first frame (``GenResult.ttff_s``,
from submit; completion for a monolithic bucket).

Guardrails (DESIGN.md §17): with ``guardrail`` the engine reads the
sampler's sentinels (aux ``latent_nonfinite``, ``sentinel_nonfinite``,
``sentinel_drift``, and a host ``isfinite`` over the latents and each
streamed chunk before it is published) once a batch; a trip steps the
bucket family down the :class:`~repro_torch.core.guardrail.
DegradationLadder` and serves the batch again under the degraded key.  A
batch that outlives ``batch_timeout_s`` (scaled by the estimator) trips
the watchdog and takes the replica down; a failing batch is retried
with backoff, then bisected so that a poison request fails alone.

Crash safety (DESIGN.md §18): with a ``journal``
(:class:`~repro_torch.serving.journal.Journal`) the engine writes a
write-ahead record per lifecycle event (``submitted`` before the request
is accepted, ``chunk``, ``finished``, ``shed``); with a
``checkpoint_store`` each streamed chunk also persists every request's
``(x_t, decision-cache state, step)`` from the sampler's chunk aux
(``aux["__ckpt__"]``).  A request with a ``resume`` payload lands in a
bucket keyed by its resume step and is served from its checkpoint
through the sampler's ``resume=`` keyword: the remaining steps only,
bit-equal to the uninterrupted run by the chunked sampler's
``step_offset`` / ``total_steps`` contract.  Failover-marked errors are
never journaled as finished, so a failed replica's requests stay
pending for a warm restart.

Lockstep (``serving.lockstep``): under a dispatch mesh that spans
processes, every rank's engine gets a :class:`~repro_torch.serving.
lockstep.Lockstep`.  Rank 0 drains, batches and sheds as above and
broadcasts each batch (its key and request ids), each attempt's ladder
policy and watchdog budget; the other ranks serve the same batches from
their own queues and never shed.  Each attempt's verdict is agreed over
the ranks, and each batch's digest is checked: a mismatch fails the
batch and every queued request on every rank, stops the engine and sets
``lockstep_error``.  A follower's request that rank 0 never batched fails
when rank 0 stops.

Per-request initial noise comes from a ``torch.Generator`` on the engine's
device seeded with ``GenRequest.seed``, and the sampler gets every
request's seed for its own draws (a DiT's class label), so a request's
result does not depend on its batch-mates.  (The JAX engine draws both
from ``jax.random.PRNGKey``; the two streams differ by design.)
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import decision_cache
from repro_torch.core.guardrail import DegradationLadder, GuardrailConfig
from repro_torch.serving import faults as fault_lib
from repro_torch.serving import slo as slo_lib
from repro_torch.serving.lockstep import LockstepError, batch_digest
from repro_torch.serving.slo import ServiceEstimator, ShedError
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("serve")

# Error-message markers that mean "the replica failed, not the request":
# the router requeues such failures onto a healthy replica.
FAILOVER_MARKERS = ("engine stopped", "watchdog")


# A follower's result for a request rank 0 shed: its result() raises
# ShedError with the rest of the text.
SHED_BY_RANK_0 = "shed by rank 0: "


def is_failover_error(msg: object) -> bool:
    """Does this error text name a replica-level failure (stop, watchdog
    trip) rather than a request-level one?"""
    text = str(msg)
    return any(marker in text for marker in FAILOVER_MARKERS)


# (latent_shape, steps, policy, reuse_every, seq_shards, txt_shape,
# stream_every, pattern_token, resume_step), in the reference's order.
BucketKey = Tuple

# A queued request: (enqueue time, request, the policy its sampler runs).
Entry = Tuple[float, "GenRequest", Any]

# Lockstep: rank 0 broadcasts an idle decision after this long without
# traffic (a follower waits for it inside the group's timeout), and a
# follower waits this long for a request rank 0 batched before it counts
# it missing.
LOCKSTEP_IDLE_S = 5.0
LOCKSTEP_WAIT_S = 60.0


def _seq_shards() -> int:
    """Seq-shard degree of the active dispatch mesh (1 = no context
    parallelism), the reference engine's fifth key entry."""
    from repro_torch.core import dispatch as dispatch_lib

    mesh = dispatch_lib.active_dispatch_mesh()
    if mesh is not None and "seq" in mesh.axis_names:
        return int(mesh.shape["seq"])
    return 1


def _bucket_policy(policy_name: Optional[str]) -> Tuple[Any, Optional[str]]:
    """The policy a bucket's sampler runs and its plan token, fixed
    together: a policy that consults state outside itself (a pattern
    policy's artifact) is pinned to that state now (its ``pin()``) and
    handed to the factory as that instance; any other stays its name."""
    from repro_torch.core.policy import get_policy

    if not policy_name:
        return policy_name, None
    try:
        pol = get_policy(policy_name)
    except KeyError:
        return policy_name, None
    pin = getattr(pol, "pin", None)
    if pin is None:
        return policy_name, pol.plan_token(None)
    pol = pin()
    return pol, pol.plan_token(None)


def _pattern_token(policy_name: Optional[str]) -> Optional[str]:
    """The bucket policy's plan token (the pattern artifact's version),
    so an artifact swap between requests builds a new sampler instead of
    serving the new traffic on the old one's pinned artifact."""
    return _bucket_policy(policy_name)[1]


def _positional_arity(fn: Optional[Callable]) -> int:
    """How many positional arguments ``fn`` accepts: two-argument
    factories take (latent_shape, steps); a third is the reuse-policy
    name, a fourth the decision-cache cadence, a fifth the streaming
    cadence.  A ``*args`` factory counts as 3, as in the JAX engine."""
    if fn is None:
        return 0
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return 2
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return 3
    return len([p for p in params
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)])


@dataclasses.dataclass
class GenRequest:
    request_id: int
    txt: np.ndarray            # (L, txt_dim) precomputed text embeddings
    latent_shape: Tuple[int, ...]
    steps: int = 50
    seed: int = 0
    # Classifier-free guidance scale: journaled with the request and read
    # by no sampler, as in the JAX package.
    guidance: float = 4.0
    # Decision-cache cadence for this request (RippleConfig.reuse_every);
    # None -> the engine default.  Part of the bucket identity.
    reuse_every: Optional[int] = None
    # Reuse-policy name (core.policy registry); None -> the engine's
    # default policy.  Part of the bucket identity.
    policy: Optional[str] = None
    # Deliver the latents every K denoising steps through
    # DiffusionEngine.stream; None -> monolithic.  Part of the bucket
    # identity.
    stream_every: Optional[int] = None
    # Absolute deadline (time.time() seconds); None -> no SLO: never
    # shed, drained behind deadline traffic by depth.  Callers with a
    # relative SLO stamp time.time() + slo_ms / 1e3 at submit.
    deadline_s: Optional[float] = None
    # Mid-flight resume payload (DESIGN.md §18): ``{"step": int, "x": the
    # latents at that step, "dstate": the decision-cache field -> array
    # mapping or None}`` from a chunk-boundary checkpoint.  Attached by
    # the warm restart and by router failover, never by clients; the
    # step joins the bucket key.
    resume: Optional[dict] = dataclasses.field(default=None, repr=False)
    # Resubmitted from a journal's recovery scan (``recovered_count``)?
    recovered: bool = False


@dataclasses.dataclass
class GenResult:
    request_id: int
    latents: Optional[np.ndarray]
    walltime_s: float            # service time of the batch that served it
    error: Optional[str] = None
    batch_index: int = -1
    latency_s: float = -1.0      # submit to result
    # Time to the first frame, from submit: the first streamed chunk for
    # a streaming bucket, completion for a monolithic one.
    ttff_s: float = -1.0
    # Deadline outcome (None: the request carried no deadline).
    deadline_met: Optional[bool] = None
    # Was the bucket below its requested policy on the guardrail ladder
    # when this result was made?
    degraded: bool = False


def request_noise(seed: int, shape: Tuple[int, ...],
                  device) -> torch.Tensor:
    """A request's initial latent noise, float32, from its own seeded
    generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


class DiffusionEngine:
    """Continuous-batching engine over bucketed samplers.

    ``sampler_factory(latent_shape, steps) -> sample_fn`` builds the
    sampler of one bucket; a factory with a third, fourth and fifth
    positional parameter also gets the bucket's policy
    (``GenRequest.policy`` or ``default_policy``), its decision-cache
    cadence (``GenRequest.reuse_every`` or ``default_reuse_every``) and
    its streaming cadence (``GenRequest.stream_every``).  A request that
    sets what its engine's factory cannot take is refused at submit.
    The policy comes as its name, or for a pattern policy as an instance
    pinned to the artifact whose version is the bucket's token; a bucket
    without a policy (None) runs the factory's own default, so name a
    pattern policy (per request or as ``default_policy``) to have its
    token in the key.  ``sample_fn(noise, txt, seeds)`` takes the batch's
    initial noise (B, *latent_shape) and text embeddings (B, L, txt_dim) on ``device``
    (default CUDA) and the requests' seeds (a list of B ints), and
    returns the final latents or ``(latents, aux)``, where a cache-aware
    sampler reports its decision-cache counters (``cache_hits`` /
    ``cache_refreshes``), which the engine logs, and a sentinel-armed one
    its guardrail readings; or, for a streaming bucket, a generator
    yielding either form once a chunk, the last chunk being the result.
    ``plan_fn(latent_shape, steps, policy)`` returns the bucket's
    attention plan, logged when its sampler is built (a string, or an
    object with ``summary()``; None logs nothing).

    ``scheduler`` is ``"edf"`` (default) or ``"hottest"``;
    ``admission_control`` sheds provably infeasible requests at submit;
    ``estimator`` (shared or own) keeps per-bucket batch times.
    ``guardrail`` is True (an own ladder), a ``GuardrailConfig`` or a
    shared ``DegradationLadder``; it needs a factory that takes a policy.
    ``batch_timeout_s`` is the watchdog's floor (None: no watchdog, the
    batch runs on the worker thread); ``max_retries`` /
    ``retry_backoff_s`` / ``bisect_on_error`` drive the error path.
    Errored results stay readable for ``error_ttl_s``.  ``journal`` and
    ``checkpoint_store`` (shared by router replicas) make the engine
    crash-safe (module doc); a sampler that takes ``resume=`` is handed
    a resumed batch's ``{"step", "dstate"}`` (the per-layer decision
    state) with its latents at that step in place of the noise.
    ``lockstep`` (a :class:`~repro_torch.serving.lockstep.Lockstep`)
    serves in step with the other ranks of a dispatch mesh that spans
    processes (module doc); ``batch_digests`` then lists each served
    batch's digest.
    """

    def __init__(self, sampler_factory: Callable, *, device=None,
                 max_batch: int = 8, max_wait_s: float = 0.05,
                 max_compiled: int = 8, starve_after_s: float = 2.0,
                 plan_fn: Optional[Callable] = None,
                 default_policy: Optional[str] = None,
                 default_reuse_every: Optional[int] = None,
                 scheduler: str = "edf",
                 admission_control: bool = True,
                 error_ttl_s: float = 60.0,
                 estimator: Optional[ServiceEstimator] = None,
                 guardrail: Any = None,
                 batch_timeout_s: Optional[float] = None,
                 max_retries: int = 1,
                 retry_backoff_s: float = 0.05,
                 bisect_on_error: bool = True,
                 journal: Any = None,
                 checkpoint_store: Any = None,
                 lockstep: Any = None):
        if scheduler not in ("edf", "hottest"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self._factory = sampler_factory
        self._factory_arity = _positional_arity(sampler_factory)
        self._factory_takes_policy = self._factory_arity >= 3
        self._factory_takes_reuse = self._factory_arity >= 4
        self._factory_takes_stream = self._factory_arity >= 5
        if default_policy is not None and not self._factory_takes_policy:
            raise ValueError(
                "default_policy is set but the sampler factory does not "
                "take a policy argument — it could not honour it")
        if default_reuse_every is not None and not self._factory_takes_reuse:
            raise ValueError(
                "default_reuse_every is set but the sampler factory does "
                "not take a reuse_every argument — it could not honour it")
        if guardrail is None or guardrail is False:
            self._ladder: Optional[DegradationLadder] = None
        elif isinstance(guardrail, DegradationLadder):
            self._ladder = guardrail
        elif isinstance(guardrail, GuardrailConfig):
            self._ladder = DegradationLadder(guardrail)
        elif guardrail is True:
            self._ladder = DegradationLadder()
        else:
            raise ValueError(f"guardrail must be True, a GuardrailConfig "
                             f"or a DegradationLadder, got {guardrail!r}")
        if self._ladder is not None and not self._factory_takes_policy:
            raise ValueError(
                "guardrail degradation rewrites the bucket policy, but "
                "this engine's sampler factory does not take a policy "
                "argument — it could not serve a degraded bucket")
        self.plan_fn = plan_fn
        self.default_policy = default_policy
        self.default_reuse_every = default_reuse_every
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_compiled = max_compiled
        self.starve_after_s = starve_after_s
        self.scheduler = scheduler
        self.admission_control = admission_control
        self.error_ttl_s = error_ttl_s
        self.estimator = estimator if estimator is not None \
            else ServiceEstimator()
        self.batch_timeout_s = batch_timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.bisect_on_error = bisect_on_error
        self.watchdog_trips = 0
        self.batch_retries = 0
        self.quarantined = 0
        self.shed_count = 0
        self.deadlines_met = 0
        self.deadlines_missed = 0
        # Crash safety (DESIGN.md §18): router replicas share both.
        self._journal = journal
        self._store = checkpoint_store
        self.recovered_count = 0    # journal-recovered resubmissions seen
        self.resumed_count = 0      # requests served from a checkpoint
        self.last_resume_step = 0   # deepest checkpoint step resumed from
        self._lockstep = lockstep
        self._shed_notices: List[Tuple[int, str]] = []  # rank 0's, unsent
        self._shed_by_leader: Dict[int, str] = {}  # a follower's, by id
        self.lockstep_error: Optional[str] = None
        self.batch_digests: List[str] = []
        self._buckets: Dict[BucketKey, deque] = {}
        self._compiled: "OrderedDict[BucketKey, Callable]" = OrderedDict()
        self._compiled_lock = threading.Lock()
        self._results: Dict[int, GenResult] = {}
        # Errored results stay readable until their TTL, so a caller that
        # retries after a TimeoutError sees the batch's error: rid ->
        # eviction time.
        self._error_expiry: Dict[int, float] = {}
        # Streamed chunks: rid -> the latents of each delivered chunk.
        self._partials: Dict[int, List[np.ndarray]] = {}
        # Tombstones of successes consumed by result(): rid -> eviction
        # time.  A stream() still iterating when result() pops the record
        # ends on the tombstone instead of waiting for its timeout; the
        # partials stay readable until it expires.
        self._finished_expiry: Dict[int, float] = {}
        self._batches_served = 0
        self._lock = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- public API -----------------------------------------------------------

    def start(self):
        with self._lock:
            self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True):
        """Stop the worker.  With ``drain`` every submitted request is
        served first; otherwise queued requests get an error result."""
        with self._lock:
            self._stop = True
            if not drain:
                self._fail_queued("engine stopped")
            self._lock.notify_all()
        if self._thread:
            self._thread.join()
            self._thread = None

    def healthy(self) -> bool:
        """Is the worker thread alive and accepting work?"""
        with self._lock:
            stopped = self._stop
        return (not stopped and self._thread is not None
                and self._thread.is_alive())

    def submit(self, req: GenRequest):
        """Enqueue one request.  Raises :class:`ShedError` when admission
        control proves its deadline cannot be met under the current queue
        depth (no compute spent, no result record), ValueError for a
        malformed request or one its factory cannot honour.  With a
        journal, the ``submitted`` record lands before the request is
        accepted (a crash after it can lose the result, never the
        request) and a shed is journaled too."""
        self._validate(req)
        rid = req.request_id
        for name, takes in (("policy", self._factory_takes_policy),
                            ("reuse_every", self._factory_takes_reuse),
                            ("stream_every", self._factory_takes_stream)):
            val = getattr(req, name)
            if val is not None and not takes:
                # Serving the default while the bucket key says otherwise
                # would be worse than refusing.
                raise ValueError(
                    f"request {rid} sets {name}={val!r} but this "
                    f"engine's sampler factory does not take a {name} "
                    "argument")
        key, policy = self._bucket(req)
        now = time.time()
        if self._journal is not None:
            self._journal.record_submitted(req)
        try:
            with self._lock:
                if self._stop:
                    raise RuntimeError("engine is stopped")
                if rid in self._shed_by_leader:
                    raise ShedError(self._shed_by_leader[rid])
                if self.admission_control and req.deadline_s is not None \
                        and not self._following:
                    dq = self._buckets.get(key)
                    reason = slo_lib.admission_decision(
                        req.deadline_s, now, len(dq) if dq else 0,
                        self.max_batch, self.estimator.lower_bound(key))
                    if reason is not None:
                        self.shed_count += 1
                        if self._lockstep is not None:
                            self._shed_notices.append(
                                (rid, f"request {rid} shed: {reason}"))
                        raise ShedError(f"request {rid} shed: {reason}")
                self._buckets.setdefault(key, deque()).append(
                    (now, req, policy))
                if req.recovered:
                    self.recovered_count += 1
                self._lock.notify_all()
        except ShedError as e:
            if self._journal is not None:
                self._journal.record_shed(rid, str(e))
            raise

    def _validate(self, req: GenRequest) -> None:
        """Refuse a malformed request at the door, before it can fail a
        whole batch inside the worker."""
        rid = req.request_id
        if not isinstance(req.steps, (int, np.integer)) or req.steps <= 0:
            raise ValueError(f"request {rid}: steps must be a "
                             f"positive int, got {req.steps!r}")
        shape = tuple(req.latent_shape) if req.latent_shape is not None \
            else ()
        if not shape or not all(isinstance(d, (int, np.integer)) and d > 0
                                for d in shape):
            raise ValueError(
                f"request {rid}: latent_shape must be a non-empty tuple "
                f"of positive ints, got {req.latent_shape!r}")
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(
                f"request {rid}: deadline_s must be an absolute "
                f"time.time() deadline (> 0), got {req.deadline_s!r}")
        for name in ("reuse_every", "stream_every"):
            val = getattr(req, name)
            if val is not None and val <= 0:
                raise ValueError(f"request {rid}: {name} must be "
                                 f"positive, got {val!r}")
        if req.resume is not None:
            step = req.resume.get("step") if isinstance(req.resume, dict) \
                else None
            if (not isinstance(step, (int, np.integer)) or step < 0
                    or step >= req.steps or "x" not in req.resume):
                raise ValueError(
                    f"request {rid}: resume payload needs an int step in "
                    f"[0, steps) and an 'x' latent, got {req.resume!r:.80}")
            if req.stream_every and step % req.stream_every != 0:
                raise ValueError(
                    f"request {rid}: resume step {step} is not a chunk "
                    f"boundary of stream_every={req.stream_every}: the "
                    "chunks would differ from the uninterrupted run's")

    def result(self, request_id: int, timeout: float = 3600.0) -> GenResult:
        deadline = time.time() + timeout
        with self._lock:
            self._evict_expired_locked()
            while request_id not in self._results:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"request {request_id}")
                self._lock.wait(timeout=remaining)
            res = self._results[request_id]
            if res.error is None:
                self._results.pop(request_id)
                self._finished_expiry.setdefault(
                    request_id, time.time() + self.error_ttl_s)
            else:
                # Kept until its TTL: a retry sees the same error.
                self._error_expiry.setdefault(
                    request_id, time.time() + self.error_ttl_s)
        if res.error is not None:
            if res.error.startswith(SHED_BY_RANK_0):
                raise ShedError(res.error[len(SHED_BY_RANK_0):])
            raise RuntimeError(f"request {request_id} failed: {res.error}")
        return res

    def peek_result(self, request_id: int) -> Optional[GenResult]:
        """Non-blocking, non-consuming lookup (the router tells served
        from lost requests with it)."""
        with self._lock:
            return self._results.get(request_id)

    def stream(self, request_id: int,
               timeout: float = 3600.0) -> Iterator[np.ndarray]:
        """Yield a streaming request's latents chunk by chunk as they
        land, in order, and end once its result is available (fetch it
        with :meth:`result`).  Raises TimeoutError when no chunk arrives
        within ``timeout`` of the previous one."""
        idx = 0
        while True:
            deadline = time.time() + timeout
            with self._lock:
                while True:
                    chunks = self._partials.get(request_id, ())
                    if len(chunks) > idx:
                        chunk = chunks[idx]
                        idx += 1
                        break
                    if (request_id in self._results
                            or request_id in self._finished_expiry):
                        return
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"request {request_id} stream stalled")
                    self._lock.wait(timeout=remaining)
            yield chunk  # outside the lock

    def pending(self) -> int:
        with self._lock:
            return sum(len(dq) for dq in self._buckets.values())

    def metrics(self) -> Dict[str, int]:
        """Serving counters: batches, sheds, deadline outcomes, the
        robustness and recovery counters and, with a journal, a
        checkpoint store or a ladder, theirs."""
        with self._lock:
            m = {"batches_served": self._batches_served,
                 "shed_count": self.shed_count,
                 "deadlines_met": self.deadlines_met,
                 "deadlines_missed": self.deadlines_missed,
                 "watchdog_trips": self.watchdog_trips,
                 "batch_retries": self.batch_retries,
                 "quarantined": self.quarantined,
                 "recovered_count": self.recovered_count,
                 "resumed_count": self.resumed_count,
                 "last_resume_step": self.last_resume_step}
        if self._journal is not None:
            m.update({k: int(v) for k, v in self._journal.metrics().items()})
        if self._store is not None:
            m.update({k: int(v) for k, v in self._store.metrics().items()})
        if self._ladder is not None:
            m.update(self._ladder.metrics())
        return m

    # -- batching loop ----------------------------------------------------------

    def _fail_queued(self, why: str) -> None:
        """Every queued request leaves its queue with the error ``why``
        (the lock is reentrant: callers may hold it)."""
        now = time.time()
        with self._lock:
            for dq in self._buckets.values():
                for _, r, _ in dq:
                    self._results[r.request_id] = GenResult(
                        r.request_id, None, 0.0, error=why)
                    self._error_expiry[r.request_id] = now + self.error_ttl_s
            self._buckets.clear()
            self._lock.notify_all()

    def _evict_expired_locked(self):
        # A record lives through its expiry instant (strictly after).
        now = time.time()
        for rid in [r for r, exp in self._error_expiry.items() if exp < now]:
            self._error_expiry.pop(rid, None)
            self._results.pop(rid, None)
            self._partials.pop(rid, None)
        for rid in [r for r, exp in self._finished_expiry.items()
                    if exp < now]:
            self._finished_expiry.pop(rid, None)
            self._partials.pop(rid, None)

    def _bucket(self, req: GenRequest) -> Tuple[BucketKey, Any]:
        """The request's bucket key and the policy its sampler runs
        (:func:`_bucket_policy`), fixed together."""
        name = req.policy or self.default_policy
        policy, token = _bucket_policy(name)
        reuse = (req.reuse_every if req.reuse_every is not None
                 else self.default_reuse_every)
        # Plain Python literals only: a checkpoint stores repr(key[:8]).
        return (tuple(int(d) for d in req.latent_shape), int(req.steps),
                name, reuse, _seq_shards(), tuple(np.shape(req.txt)),
                req.stream_every,
                token, int(req.resume["step"]) if req.resume else 0), policy

    def _bucket_key(self, req: GenRequest) -> BucketKey:
        return self._bucket(req)[0]

    def _next_bucket(self) -> Optional[BucketKey]:
        """The drain order of :func:`repro_torch.serving.slo.choose_bucket`
        (starvation aging, EDF, deepest); the caller holds the lock."""
        heads = {k: (dq[0][0], dq[0][1].deadline_s, len(dq))
                 for k, dq in self._buckets.items() if dq}
        return slo_lib.choose_bucket(
            heads, time.time(), scheduler=self.scheduler,
            starve_after_s=self.starve_after_s, estimator=self.estimator)

    def _take_batch(self, idle_s: Optional[float] = None):
        """Block for traffic, pick a bucket (:meth:`_next_bucket`) and
        linger for batch-mates from the same bucket; (None, None) once
        stopped and drained, and (None, []) after ``idle_s`` without
        traffic."""
        t_idle = None if idle_s is None else time.time() + idle_s
        with self._lock:
            while True:
                key = self._next_bucket()
                if key is not None:
                    break
                if self._stop:
                    return None, None
                if t_idle is not None and time.time() >= t_idle:
                    return None, []
                self._lock.wait(timeout=0.2)
            batch = [self._buckets[key].popleft()]
            deadline = time.time() + self.max_wait_s
            while len(batch) < self.max_batch and not self._stop:
                dq = self._buckets.get(key)
                while dq and len(batch) < self.max_batch:
                    batch.append(dq.popleft())
                remaining = deadline - time.time()
                if len(batch) >= self.max_batch or remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
        return key, batch

    # -- lockstep over the ranks (serving.lockstep) --------------------------

    @property
    def _following(self) -> bool:
        return self._lockstep is not None and not self._lockstep.leader

    def _lockstep_batch(self):
        """:meth:`_take_batch` in step with the other ranks: rank 0 takes
        the batch and broadcasts it with its sheds; the others take the
        same request ids from their own queues.  Each batch's digest is
        checked on every rank.  (None, None) once rank 0 has stopped or
        the ranks disagree, (None, []) when rank 0 was idle."""
        ls = self._lockstep
        if ls.leader:
            key, batch = self._take_batch(idle_s=LOCKSTEP_IDLE_S)
            with self._lock:
                shed, self._shed_notices = self._shed_notices, []
            ls.share({"stop": batch is None, "key": key, "shed": shed,
                      "rids": [r.request_id for _, r, _ in batch or ()]})
        else:
            d = ls.share()
            self._follow_sheds(d["shed"])
            if d["stop"]:
                self._fail_queued("rank 0 stopped without serving it")
                return None, None
            key, batch = d["key"], self._take_ids(d["rids"])
        if batch is None:
            return None, None
        if not batch:
            return None, []
        missing = [e is None for e in batch]
        digest = (f"missing request(s) at {missing}" if any(missing)
                  else batch_digest(key, [r for _, r, _ in batch]))
        try:
            ls.check(f"batch of bucket {key}", digest)
        except LockstepError as e:
            self._lockstep_failed([b for b in batch if b is not None], e)
            return None, None
        self.batch_digests.append(digest)
        return key, batch

    def _follow_sheds(self, shed: List[Tuple[int, str]]) -> None:
        """Rank 0's sheds: a request already queued here leaves the queue
        and its result raises ShedError; one submitted later is shed at
        its submit."""
        if not shed:
            return
        gone = dict(shed)
        now = time.time()
        with self._lock:
            self._shed_by_leader.update(gone)
            self.shed_count += len(gone)
            for dq in self._buckets.values():
                for e in [e for e in dq if e[1].request_id in gone]:
                    dq.remove(e)
                    rid = e[1].request_id
                    self._results[rid] = GenResult(
                        rid, None, 0.0, error=SHED_BY_RANK_0 + gone[rid])
                    self._error_expiry[rid] = now + self.error_ttl_s
            self._lock.notify_all()

    def _take_ids(self, rids: List[int]) -> List[Optional[Entry]]:
        """The queued entries of ``rids`` in their order, waiting up to
        ``LOCKSTEP_WAIT_S`` for any not submitted yet (None for those
        still missing)."""
        deadline = time.time() + LOCKSTEP_WAIT_S
        with self._lock:
            while True:
                found = {e[1].request_id: (k, e)
                         for k, dq in self._buckets.items() for e in dq
                         if e[1].request_id in rids}
                if len(found) == len(rids) or time.time() >= deadline:
                    break
                self._lock.wait(timeout=0.2)
            out: List[Optional[Entry]] = []
            for rid in rids:
                if rid in found:
                    k, e = found[rid]
                    self._buckets[k].remove(e)
                    out.append(e)
                else:
                    out.append(None)
            return out

    def _lockstep_failed(self, batch: List[Entry], err: Exception) -> None:
        """The ranks disagree: the batch and every queued request fail on
        this rank (as on every other), and the engine stops."""
        log.error("lockstep: %s", err)
        self.lockstep_error = str(err)
        now = time.time()
        with self._lock:
            self._stop = True
            for _, r, _ in batch:
                self._results[r.request_id] = GenResult(
                    r.request_id, None, 0.0, error=f"lockstep: {err}")
                self._error_expiry[r.request_id] = now + self.error_ttl_s
        self._fail_queued(f"lockstep: {err}")

    def _agree(self, hung: bool, exc, sent) -> Tuple[bool, Any, Any]:
        """One attempt's verdict over the ranks: each rank's outcome
        all-gathered, the worst (hung, failed, sentinel trip, clean) taken
        by all, the lowest rank's among equals."""
        mine = (("hung", "") if hung else ("err", repr(exc)) if exc is not None
                else ("sentinel", sent) if sent is not None else ("ok", ""))
        order = {"hung": 0, "err": 1, "sentinel": 2, "ok": 3}
        got = self._lockstep.gather(mine)
        rank, (kind, what) = min(enumerate(got),
                                 key=lambda rg: (order[rg[1][0]], rg[0]))
        if kind == "hung":
            return True, None, None
        if kind == "err":
            return False, exc if mine[0] == "err" else RuntimeError(
                f"rank {rank}: {what}"), None
        if kind == "sentinel":
            return False, None, sent if mine[0] == "sentinel" else what
        return False, None, None

    def _sampler(self, key: BucketKey, policy) -> Callable:
        """The bucket's sampler from the LRU (keyed on ``key[:8]``), built
        around ``policy`` (the one fixed with the key) and its plan
        logged on a miss."""
        key = key[:8]
        with self._compiled_lock:
            fn = self._compiled.get(key)
            if fn is None:
                shape, steps, _, reuse = key[:4]
                fn = self._factory(*(shape, steps, policy, reuse,
                                     key[6])[:min(self._factory_arity, 5)])
                self._compiled[key] = fn
                if self.plan_fn is not None:
                    try:
                        plan = self.plan_fn(shape, steps, policy)
                        if plan is not None:
                            log.info("bucket %s plan: %s", key,
                                     plan if isinstance(plan, str)
                                     else plan.summary())
                    except Exception:  # noqa: BLE001 — logging must not fail the batch
                        log.exception("plan_fn failed for bucket %s", key)
                while len(self._compiled) > self.max_compiled:
                    evicted, _ = self._compiled.popitem(last=False)
                    log.info("evicted the sampler of bucket %s", evicted)
            self._compiled.move_to_end(key)
            return fn

    @staticmethod
    def _split_out(out) -> Tuple[Any, Optional[dict]]:
        """(latents, aux) vs bare latents."""
        if isinstance(out, (tuple, list)) and len(out) == 2:
            return out[0], out[1]
        return out, None

    def _publish_chunk(self, batch: List[Entry], lat: np.ndarray, pub: Dict,
                       chunk_idx: int, abandoned: threading.Event):
        """Deliver one streamed chunk to every request's subscribers and
        stamp the TTFF at the first.  ``pub`` survives re-serves: a chunk
        an earlier attempt delivered is not delivered again, and an
        abandoned (watchdog-tripped) worker's late chunks are dropped."""
        now = time.time()
        with self._lock:
            if abandoned.is_set():
                return
            for i, (t_enq, r, _) in enumerate(batch):
                if chunk_idx < pub["count"].get(r.request_id, 0):
                    continue
                pub["ttff"].setdefault(r.request_id, now - t_enq)
                self._partials.setdefault(r.request_id, []).append(lat[i])
                pub["count"][r.request_id] = chunk_idx + 1
            self._lock.notify_all()

    @staticmethod
    def _log_aux(key: BucketKey, aux: Optional[dict]):
        """Log a cache-aware sampler's decision-cache hit rate, so the
        amortization shows in serving."""
        if not aux:
            return
        hits = int(aux.get("cache_hits", 0))
        refr = int(aux.get("cache_refreshes", 0))
        if hits + refr:
            log.info("bucket %s decision cache: %d hits / %d refreshes "
                     "(hit rate %.2f)", key, hits, refr,
                     hits / max(hits + refr, 1))

    # -- guardrail and watchdog (DESIGN.md §17) -------------------------------

    @staticmethod
    def _family(key: BucketKey):
        """The key without its policy and pattern token: the unit the
        ladder keys on."""
        return key[:2] + key[3:7]

    @staticmethod
    def _rekey(key: BucketKey, policy: Optional[str]) -> BucketKey:
        """The same bucket one rung down: policy and pattern token
        rewritten, so the degraded bucket gets a sampler of its own."""
        return (key[:2] + (policy,) + key[3:7]
                + (_pattern_token(policy),) + key[8:])

    def _sentinel_verdict(self, lat: Optional[np.ndarray],
                          aux: Optional[dict]) -> Optional[str]:
        """None when the batch is clean, else the trip's reason: a host
        ``isfinite`` over the latents, then the sampler's sentinel counts
        (read from the device here, once a batch)."""
        gcfg = self._ladder.config
        if lat is not None and not np.all(np.isfinite(lat)):
            return "non-finite final latents"
        if aux:
            nf = 0
            for k in ("latent_nonfinite", "sentinel_nonfinite"):
                if k in aux:
                    nf += int(aux[k])
            if nf > gcfg.max_nonfinite:
                return f"{nf} non-finite sentinel entr(ies)"
            if "sentinel_drift" in aux:
                drift = float(aux["sentinel_drift"])
                if not np.isfinite(drift):
                    return "non-finite drift probe"
                if gcfg.drift_tol > 0 and drift > gcfg.drift_tol:
                    return (f"drift probe {drift:.3g} > "
                            f"tol {gcfg.drift_tol:.3g}")
        return None

    # -- crash safety (DESIGN.md §18) -----------------------------------------

    @staticmethod
    def _accepts_resume(fn: Callable) -> bool:
        """Does this sampler take a ``resume=`` keyword?  One that does
        not serves a resumed request by replay from step 0: slower, the
        same latents."""
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            return False
        return "resume" in params or any(
            p.kind == p.VAR_KEYWORD for p in params.values())

    def _assemble_resume(self, key: BucketKey, batch: List[Entry],
                         fn: Callable) -> Optional[Dict[str, Any]]:
        """The batch's resume payload ``{"x", "step", "dstate"}`` from its
        requests' checkpoints, or None for fresh traffic and samplers
        without ``resume=``.  The key pins the step, so batchmates share
        it; their latents stack on axis 0 and their decision states
        (layer-stacked, batch axis 1) merge and split into the per-layer
        list the model carries."""
        step = key[8]
        if step <= 0:
            return None
        payloads = [r.resume for _, r, _ in batch]
        if not self._accepts_resume(fn):
            log.warning("bucket %s: sampler takes no resume argument; "
                        "replaying %d checkpointed request(s) from step 0",
                        key, len(batch))
            return None
        xs = torch.stack([torch.as_tensor(p["x"]) for p in payloads]).to(
            device=self.device, dtype=torch.float32)
        dstates = [p.get("dstate") for p in payloads]
        merged = None
        if all(d is not None for d in dstates):
            merged = decision_cache.unstack_layers(decision_cache.merge_states(
                [decision_cache.state_from_arrays(d, device=self.device)
                 for d in dstates]))
        elif any(d is not None for d in dstates):
            log.warning("bucket %s: mixed cache/cache-less checkpoints in "
                        "one batch; resuming without decision state", key)
        return {"x": xs, "step": int(step), "dstate": merged}

    @staticmethod
    def _request_states(dstate, batch_size: int):
        """Per-request layer-stacked slices (batch axis 1, kept as a
        size-1 dim so ``merge_states`` is the inverse) of the sampler's
        per-layer decision state, as ``field -> tensor`` maps; None when
        the state has no batch axis to slice (a layer without a plan yet,
        or a leaf broadcast over the batch)."""
        if not dstate or any(st is None for st in dstate):
            return None
        leaves = [v for st in dstate for v in vars(st).values()
                  if v is not None]
        if any(v.dim() < 1 or v.shape[0] != batch_size for v in leaves):
            return None
        return [vars(decision_cache.stack_layers(
            [decision_cache.slice_state(st, i, batch_axis=0)
             for st in dstate])) for i in range(batch_size)]

    def _record_chunk(self, key: BucketKey, batch: List[Entry],
                      lat: np.ndarray, ck: Optional[Dict], ci: int,
                      abandoned: threading.Event):
        """The durable side of one delivered chunk: a ``chunk`` journal
        record per request, and with a store and the sampler's
        ``__ckpt__`` each request's ``(x_t, decision state, step)``
        checkpoint (not on the final chunk: the request is about to
        finish and its checkpoint would be discarded).  A watchdog-
        abandoned zombie batch writes nothing.  A failed checkpoint write
        is logged and serving goes on, as in the JAX package: the journal
        is the source of truth."""
        if (self._journal is None and self._store is None) \
                or abandoned.is_set():
            return
        step = ck.get("step") if ck else None
        stream = key[6] or 0
        base_ci = key[8] // stream if stream else 0
        if self._journal is not None:
            for _, r, _ in batch:
                try:
                    self._journal.record_chunk(r.request_id, base_ci + ci,
                                               step)
                except RuntimeError:
                    return  # the journal closed during shutdown
        if self._store is None or step is None or int(step) >= key[1]:
            return
        per = self._request_states(ck.get("dstate"), len(batch))
        for i, (_, r, _) in enumerate(batch):
            try:
                self._store.put(r.request_id, step=int(step), x=lat[i],
                                seed=r.seed, bucket=key[:8],
                                dstate=None if per is None else per[i])
            except OSError as e:
                log.warning("checkpoint write failed for request %d: %s",
                            r.request_id, e)

    def _run_batch(self, key: BucketKey, batch: List[Entry], policy,
                   pub: Dict, abandoned: threading.Event,
                   budget: Optional[float] = None):
        """One sampler invocation, under the watchdog when it is on.
        Returns ``(res, hung, budget)``: ``res`` holds ``lat`` / ``aux``,
        or ``err`` (the exception), or ``sentinel`` (a streamed chunk was
        not finite; caught before it was published)."""
        res: Dict[str, Any] = {}

        def work():
            try:
                fault = fault_lib.active_faults()
                if fault is not None:
                    fault.check_poison([r.request_id for _, r, _ in batch])
                    fault.maybe_raise()
                    if fault.maybe_hang():
                        return  # hung past the watchdog; the batch is lost
                fn = self._sampler(key, policy)
                txt = torch.from_numpy(np.stack(
                    [np.asarray(r.txt, np.float32) for _, r, _ in batch]))
                seeds = [r.seed for _, r, _ in batch]
                resume = self._assemble_resume(key, batch, fn)
                if resume is not None:
                    # Mid-flight resume: the checkpointed latents replace
                    # the noise and the sampler starts at their step.
                    x = resume.pop("x")
                    out = fn(x, txt.to(self.device), seeds, resume=resume)
                else:
                    noise = torch.stack([request_noise(r.seed, key[0],
                                                       self.device)
                                         for _, r, _ in batch])
                    out = fn(noise, txt.to(self.device), seeds)
                if inspect.isgenerator(out):
                    # A streaming bucket: each chunk goes to the
                    # subscribers as it lands; the last is the result.
                    lat = aux = None
                    for ci, chunk in enumerate(out):
                        lat, aux = self._split_out(chunk)
                        ck = (aux.pop("__ckpt__", None)
                              if isinstance(aux, dict) else None)
                        lat = lat.float().cpu().numpy()
                        if (self._ladder is not None
                                and not np.all(np.isfinite(lat))):
                            res["sentinel"] = \
                                f"non-finite streamed chunk {ci}"
                            return
                        self._publish_chunk(batch, lat, pub, ci, abandoned)
                        self._record_chunk(key, batch, lat, ck, ci,
                                           abandoned)
                        # Not held while the next chunk runs: it would
                        # keep a second plan a layer alive.
                        ck = None
                    if lat is None:
                        raise RuntimeError("streaming sampler yielded nothing")
                else:
                    lat, aux = self._split_out(out)
                    lat = lat.float().cpu().numpy()
                res["lat"], res["aux"] = lat, aux
            except Exception as e:  # noqa: BLE001 — fail the batch, not the engine
                log.exception("bucket %s batch failed", key)
                res["err"] = e

        if self.batch_timeout_s is None:
            work()
            return res, False, 0.0
        if budget is None:
            budget = self.estimator.timeout_hint(key, self.batch_timeout_s)
        worker = threading.Thread(target=work, daemon=True)
        worker.start()
        worker.join(timeout=budget)
        return res, worker.is_alive(), budget

    def _trip_watchdog(self, key: BucketKey, batch: List[Entry],
                       budget: float, abandoned: threading.Event):
        """A batch outlived its budget.  Its worker cannot be killed (a
        CUDA call cannot be cancelled), so the replica steps down: the
        engine stops (``healthy()`` False), the hung and the queued
        requests get failover-marked errors for the router to requeue,
        and the abandoned worker's late chunks are dropped."""
        abandoned.set()
        log.error("watchdog: bucket %s batch of %d hung past %.1fs — "
                  "marking replica unhealthy", key, len(batch), budget)
        now = time.time()
        with self._lock:
            self.watchdog_trips += 1
            self._stop = True
            err = f"watchdog: batch hung after {budget:.1f}s"
            for t_enq, r, _ in batch:
                if r.deadline_s is not None:
                    self.deadlines_missed += 1
                self._results[r.request_id] = GenResult(
                    r.request_id, None, now - t_enq, error=err,
                    latency_s=now - t_enq,
                    deadline_met=False if r.deadline_s is not None
                    else None)
                self._error_expiry[r.request_id] = now + self.error_ttl_s
            self._fail_queued("engine stopped (watchdog)")

    def _publish_batch(self, batch: List[Entry], lat: Optional[np.ndarray],
                       dt: float, pub: Dict, err: Optional[str],
                       degraded: bool):
        now = time.time()
        with self._lock:
            bi = self._batches_served
            self._batches_served += 1
            for i, (t_enq, r, _) in enumerate(batch):
                met = None
                if r.deadline_s is not None:
                    met = err is None and now <= r.deadline_s
                    if met:
                        self.deadlines_met += 1
                    else:
                        self.deadlines_missed += 1
                self._results[r.request_id] = GenResult(
                    r.request_id, None if err else lat[i], dt, error=err,
                    batch_index=bi, latency_s=now - t_enq,
                    ttff_s=pub["ttff"].get(r.request_id,
                                           -1.0 if err else now - t_enq),
                    deadline_met=met, degraded=degraded)
                if err is not None:
                    self._error_expiry[r.request_id] = now + self.error_ttl_s
            resume = batch[0][1].resume
            if err is None and resume:
                self.resumed_count += len(batch)
                self.last_resume_step = max(self.last_resume_step,
                                            int(resume["step"]))
            self._lock.notify_all()
        # The durable terminal records, outside the lock.  A failover-
        # marked error (replica down, watchdog) is not journaled as
        # finished: the request is still owed a result and stays pending
        # for recovery; a request-level error is, so a restart never
        # resurrects it.
        if self._journal is None and self._store is None:
            return
        for _, r, _ in batch:
            if err is not None and is_failover_error(err):
                continue
            if self._journal is not None:
                try:
                    self._journal.record_finished(r.request_id, error=err)
                except RuntimeError:
                    break  # the journal closed during shutdown
            if self._store is not None:
                self._store.discard(r.request_id)

    def _serve(self, key: BucketKey, batch: List[Entry]):
        pub: Dict[str, Dict] = {"ttff": {}, "count": {}}
        self._serve_rec(key, batch, 0, pub, threading.Event())

    def _serve_rec(self, key: BucketKey, batch: List[Entry], depth: int,
                   pub: Dict, abandoned: threading.Event):
        """Serve one (sub-)batch through the escalation chain: a sentinel
        trip degrades one rung and serves again; a hang trips the
        watchdog; an error is retried with backoff, then the batch is
        bisected so a poison request is quarantined alone."""
        t0 = time.time()
        base_pol = key[2]
        fam = self._family(key)
        attempt = 0
        while True:
            eff_key, policy, eff_pol, budget = key, batch[0][2], base_pol, None
            if self._ladder is not None:
                eff_pol, _probing = self._ladder.effective_policy(
                    fam, base_pol)
            if self._lockstep is not None:
                # Rank 0's rung and watchdog budget for this attempt.
                eff_pol, budget = self._lockstep.share((eff_pol, None if (
                    self.batch_timeout_s is None) else self.estimator
                    .timeout_hint(key, self.batch_timeout_s)))
            if eff_pol != base_pol:
                eff_key = self._rekey(key, eff_pol)
                policy = _bucket_policy(eff_pol)[0]
            res, hung, budget = self._run_batch(eff_key, batch, policy, pub,
                                                abandoned, budget)
            sent = exc = None
            if not hung:
                sent = res.get("sentinel")
                exc = res.get("err")
                if exc is None and sent is None and "lat" not in res:
                    exc = RuntimeError("sampler worker produced no output")
                if exc is None and sent is None and self._ladder is not None:
                    sent = self._sentinel_verdict(res.get("lat"),
                                                  res.get("aux"))
            if self._lockstep is not None:
                hung, exc, sent = self._agree(hung, exc, sent)
            if hung:
                self._trip_watchdog(eff_key, batch, budget, abandoned)
                return
            if sent is not None and self._ladder is not None:
                nxt = self._ladder.trip(fam, base_pol)
                if nxt is not None:
                    log.warning(
                        "bucket %s guardrail trip (%s): degrading to %r "
                        "and re-serving", key, sent, nxt)
                    continue
                exc = RuntimeError(
                    f"guardrail: {sent} at the dense floor — no "
                    "degradation step left")
            elif sent is None and exc is None and self._ladder is not None:
                self._ladder.record_clean(fam)
            if exc is None:
                dt = time.time() - t0
                self._log_aux(eff_key, res.get("aux"))
                self.estimator.observe(key, dt)
                if eff_key != key:
                    self.estimator.observe(eff_key, dt)
                self._publish_batch(
                    batch, res["lat"], dt, pub, None,
                    degraded=(self._ladder is not None
                              and self._ladder.degraded(fam)))
                log.info("served bucket %s batch of %d in %.2fs%s", key,
                         len(batch), dt,
                         " (degraded)" if eff_key != key else "")
                return
            # The error path.  A dead end at the dense floor is not
            # transient: no retry, no bisection.
            attempt += 1
            if sent is None and attempt <= self.max_retries:
                backoff = self.retry_backoff_s * (2 ** (attempt - 1))
                with self._lock:
                    self.batch_retries += 1
                log.warning("bucket %s batch failed (attempt %d/%d), "
                            "retrying in %.2fs: %r", key, attempt,
                            self.max_retries + 1, backoff, exc)
                time.sleep(backoff)
                continue
            if sent is None and self.bisect_on_error and len(batch) > 1:
                mid = len(batch) // 2
                log.warning("bucket %s: bisecting failed batch of %d to "
                            "isolate the poison request", key, len(batch))
                self._serve_rec(key, batch[:mid], depth + 1, pub, abandoned)
                self._serve_rec(key, batch[mid:], depth + 1, pub, abandoned)
                return
            if depth > 0 and len(batch) == 1:
                # Bisection ended on one request: it fails alone.
                with self._lock:
                    self.quarantined += 1
                log.error("bucket %s: request %d quarantined after "
                          "bisection: %r", key, batch[0][1].request_id, exc)
            self._publish_batch(batch, None, time.time() - t0, pub,
                                repr(exc), degraded=False)
            return

    def _loop(self):
        while True:
            if self._lockstep is None:
                key, batch = self._take_batch()
            else:
                key, batch = self._lockstep_batch()
            if batch is None:
                return
            if not batch:
                continue
            self._serve(key, batch)
            fault = fault_lib.active_faults()
            if fault is not None:
                fault.maybe_corrupt_artifact(self._batches_served)


class LMEngine:
    """Prefill + decode serving for the LM family.

    ``prefill_fn(tokens)`` gives (logits (B, S|1, V), cache) and
    ``decode_fn(token (B, 1), cache, index)`` (logits (B, 1, V), cache),
    as the port's ``launch.workloads.lm_serve_steps`` returns them."""

    def __init__(self, prefill_fn: Callable, decode_fn: Callable,
                 max_len: int):
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.max_len = max_len

    @torch.no_grad()
    def generate(self, tokens: torch.Tensor, num_new: int,
                 temperature: float = 0.0,
                 rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens: (B, S) prompt -> (B, num_new) continuations, greedy
        (argmax) or sampled at ``temperature`` from the softmax of the
        float32 logits.  Sampling needs an explicit ``rng``, a
        ``torch.Generator`` on the logits' device; the draws differ from
        the JAX engine's by design, greedy tokens do not.  ``prompt +
        num_new`` must fit ``max_len``.  The decode step after the last
        token, whose logits the JAX engine computes and drops, is not
        run."""
        B, S = tokens.shape
        if S + num_new > self.max_len:
            raise ValueError(
                f"prompt ({S}) + num_new ({num_new}) = {S + num_new} "
                f"exceeds max_len={self.max_len}; the KV cache was "
                f"allocated for max_len positions")
        if temperature > 0 and rng is None:
            raise ValueError("temperature > 0 requires an explicit rng "
                             "(a torch.Generator)")
        logits, cache = self.prefill_fn(tokens)
        out = []
        for i in range(num_new):
            last = logits[:, -1]
            if temperature > 0:
                probs = torch.softmax(last.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=rng)[:, 0]
            else:
                nxt = torch.argmax(last, dim=-1)
            out.append(nxt)
            if i + 1 < num_new:
                logits, cache = self.decode_fn(nxt[:, None], cache, S + i)
        return torch.stack(out, dim=1)

"""Serving engine: shape-bucketed continuous batching for video and
image generation.

Requests are keyed into a **bucket** by the reference's 9-tuple
``(latent_shape, steps, policy, reuse_every, seq_shards, txt_shape,
stream_every, pattern_token, resume_step)``, so one sampler invocation
never pads or mixes shapes, reuse policies, decision-cache cadences or
streaming cadences.  ``seq_shards`` is 1 and ``resume_step`` 0 until the
port has context parallelism and checkpointed resume.  The pattern token
is the bucket policy's ``plan_token`` (the pattern artifact's version),
fixed at submit together with the policy the sampler runs: a pattern
policy is pinned there to the artifact active then, and that pinned
policy travels with the request to the factory, so the sampler built for
a key (also after an eviction) runs on the artifact the key names, and
traffic after an artifact swap gets a sampler of its own.  A worker thread drains the deepest bucket first (ties to the
oldest head), lingers ``max_wait_s`` for batch-mates from the same
bucket up to ``max_batch``, and runs that bucket's sampler, held in a
bounded LRU (keyed on ``key[:8]``) of ``sampler_factory(latent_shape,
steps[, policy[, reuse_every[, stream_every]]])`` results; ``plan_fn``
lets the launcher log each bucket's attention plan when its sampler is
built.

Streaming: a factory that honours ``stream_every`` returns a *generator*
sampler yielding the latents every K denoising steps; the engine
publishes each chunk to :meth:`DiffusionEngine.stream` subscribers as it
lands and records the time to the first frame (``GenResult.ttff_s``,
from submit; completion for a monolithic bucket).

Per-request initial noise comes from a ``torch.Generator`` on the engine's
device seeded with ``GenRequest.seed``, and the sampler gets every
request's seed for its own draws (a DiT's class label), so a request's
result does not depend on its batch-mates.  (The JAX engine draws both
from ``jax.random.PRNGKey``; the two streams differ by design.)
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

log = logging.getLogger("repro_torch.serve")

# (latent_shape, steps, policy, reuse_every, seq_shards, txt_shape,
# stream_every, pattern_token, resume_step), in the reference's order.
BucketKey = Tuple

# How long the chunks of a consumed result stay readable by stream().
_FINISHED_TTL_S = 60.0


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
    ``cache_refreshes``), which the engine logs; or, for a streaming
    bucket, a generator yielding either form once a chunk, the last
    chunk being the result.  ``plan_fn(latent_shape, steps, policy)``
    returns the bucket's attention plan, logged when its sampler is
    built (a string, or an object with ``summary()``; None logs
    nothing).
    """

    def __init__(self, sampler_factory: Callable, *, device=None,
                 max_batch: int = 8, max_wait_s: float = 0.05,
                 max_compiled: int = 8,
                 plan_fn: Optional[Callable] = None,
                 default_policy: Optional[str] = None,
                 default_reuse_every: Optional[int] = None):
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
        self.plan_fn = plan_fn
        self.default_policy = default_policy
        self.default_reuse_every = default_reuse_every
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_compiled = max_compiled
        self._buckets: Dict[BucketKey, deque] = {}
        self._compiled: "OrderedDict[BucketKey, Callable]" = OrderedDict()
        self._results: Dict[int, GenResult] = {}
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
                for dq in self._buckets.values():
                    for _, r, _ in dq:
                        self._results[r.request_id] = GenResult(
                            r.request_id, None, 0.0, error="engine stopped")
                self._buckets.clear()
            self._lock.notify_all()
        if self._thread:
            self._thread.join()
            self._thread = None

    def submit(self, req: GenRequest):
        rid = req.request_id
        if not isinstance(req.steps, (int, np.integer)) or req.steps <= 0:
            raise ValueError(f"request {rid}: steps must be a "
                             f"positive int, got {req.steps!r}")
        for name in ("reuse_every", "stream_every"):
            val = getattr(req, name)
            if val is not None and val <= 0:
                raise ValueError(f"request {rid}: {name} must be "
                                 f"positive, got {val!r}")
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
        with self._lock:
            if self._stop:
                raise RuntimeError("engine is stopped")
            self._buckets.setdefault(key, deque()).append(
                (time.time(), req, policy))
            self._lock.notify_all()

    def result(self, request_id: int, timeout: float = 3600.0) -> GenResult:
        deadline = time.time() + timeout
        with self._lock:
            self._evict_finished_locked()
            while request_id not in self._results:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"request {request_id}")
                self._lock.wait(timeout=remaining)
            res = self._results.pop(request_id)
            if res.error is None:
                self._finished_expiry.setdefault(
                    request_id, time.time() + _FINISHED_TTL_S)
            else:
                self._partials.pop(request_id, None)
        if res.error is not None:
            raise RuntimeError(f"request {request_id} failed: {res.error}")
        return res

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

    def metrics(self) -> Dict[str, int]:
        """Serving counters."""
        with self._lock:
            return {"batches_served": self._batches_served}

    # -- batching loop ----------------------------------------------------------

    def _evict_finished_locked(self):
        now = time.time()
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
        return (tuple(req.latent_shape), int(req.steps), name, reuse, 1,
                tuple(np.shape(req.txt)), req.stream_every, token, 0), policy

    def _bucket_key(self, req: GenRequest) -> BucketKey:
        return self._bucket(req)[0]

    def _take_batch(self):
        with self._lock:
            while True:
                live = [(len(dq), -dq[0][0], k)
                        for k, dq in self._buckets.items() if dq]
                if live:
                    key = max(live, key=lambda e: e[:2])[2]
                    break
                if self._stop:
                    return None, None
                self._lock.wait(timeout=0.2)
            batch = [self._buckets[key].popleft()]
            deadline = time.time() + self.max_wait_s
            while len(batch) < self.max_batch and not self._stop:
                dq = self._buckets[key]
                while dq and len(batch) < self.max_batch:
                    batch.append(dq.popleft())
                remaining = deadline - time.time()
                if len(batch) >= self.max_batch or remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
        return key, batch

    def _sampler(self, key: BucketKey, policy) -> Callable:
        """The bucket's sampler from the LRU (keyed on ``key[:8]``), built
        around ``policy`` (the one fixed with the key) and its plan
        logged on a miss."""
        key = key[:8]
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

    def _publish_chunk(self, batch, lat: np.ndarray, ttff: Dict[int, float]):
        """Deliver one streamed chunk to every request's subscribers and
        stamp the TTFF at the first."""
        now = time.time()
        with self._lock:
            for i, (t_enq, r, _) in enumerate(batch):
                ttff.setdefault(r.request_id, now - t_enq)
                self._partials.setdefault(r.request_id, []).append(lat[i])
            self._lock.notify_all()

    def _serve(self, key: BucketKey, batch: List[Tuple[float, GenRequest, Any]]):
        t0 = time.time()
        lat, err = None, None
        ttff: Dict[int, float] = {}
        try:
            # Every request of a bucket carries an equal policy (one token).
            fn = self._sampler(key, batch[0][2])
            noise = torch.stack([request_noise(r.seed, key[0], self.device)
                                 for _, r, _ in batch])
            txt = torch.from_numpy(np.stack([np.asarray(r.txt, np.float32)
                                             for _, r, _ in batch]))
            seeds = [r.seed for _, r, _ in batch]
            out = fn(noise, txt.to(self.device), seeds)
            if inspect.isgenerator(out):
                # A streaming bucket: each chunk goes to the subscribers
                # as it lands; the last is the result.
                aux = None
                for chunk in out:
                    lat, aux = self._split_out(chunk)
                    lat = lat.float().cpu().numpy()
                    self._publish_chunk(batch, lat, ttff)
                if lat is None:
                    raise RuntimeError("streaming sampler yielded nothing")
            else:
                lat, aux = self._split_out(out)
                lat = lat.float().cpu().numpy()
            self._log_aux(key, aux)
        except Exception as e:  # noqa: BLE001 — fail the batch, not the engine
            log.exception("bucket %s batch failed", key)
            err = repr(e)
        now = time.time()
        with self._lock:
            bi = self._batches_served
            self._batches_served += 1
            for i, (t_enq, r, _) in enumerate(batch):
                self._results[r.request_id] = GenResult(
                    r.request_id, None if err else lat[i], now - t0,
                    error=err, batch_index=bi, latency_s=now - t_enq,
                    ttff_s=ttff.get(r.request_id,
                                    -1.0 if err else now - t_enq))
            self._lock.notify_all()
        log.info("served bucket %s batch of %d in %.2fs", key, len(batch),
                 now - t0)

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

    def _loop(self):
        while True:
            key, batch = self._take_batch()
            if key is None:
                return
            self._serve(key, batch)

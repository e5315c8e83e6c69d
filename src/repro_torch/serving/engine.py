"""Serving engine: shape-bucketed continuous batching for video
generation.

Requests are keyed into a **bucket** by ``(latent_shape, steps,
txt_shape)``, so one sampler invocation never pads or mixes shapes.  A
worker thread drains the deepest bucket first (ties to the oldest head),
lingers ``max_wait_s`` for batch-mates from the same bucket up to
``max_batch``, and runs that bucket's sampler, held in a bounded LRU of
``sampler_factory(latent_shape, steps)`` results.

Per-request initial noise comes from a ``torch.Generator`` on the engine's
device seeded with ``GenRequest.seed``, and the sampler gets every
request's seed for its own draws (a DiT's class label), so a request's
result does not depend on its batch-mates.  (The JAX engine draws both
from ``jax.random.PRNGKey``; the two streams differ by design.)
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

log = logging.getLogger("repro_torch.serve")

BucketKey = Tuple


@dataclasses.dataclass
class GenRequest:
    request_id: int
    txt: np.ndarray            # (L, txt_dim) precomputed text embeddings
    latent_shape: Tuple[int, ...]
    steps: int = 50
    seed: int = 0


@dataclasses.dataclass
class GenResult:
    request_id: int
    latents: Optional[np.ndarray]
    walltime_s: float            # service time of the batch that served it
    error: Optional[str] = None
    batch_index: int = -1
    latency_s: float = -1.0      # submit to result


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
    sampler of one bucket; ``sample_fn(noise, txt, seeds)`` takes the
    batch's initial noise (B, *latent_shape) and text embeddings
    (B, L, txt_dim) on ``device`` (default CUDA) and the requests' seeds
    (a list of B ints), and returns the final latents.
    """

    def __init__(self, sampler_factory: Callable, *, device=None,
                 max_batch: int = 8, max_wait_s: float = 0.05,
                 max_compiled: int = 8):
        self._factory = sampler_factory
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_compiled = max_compiled
        self._buckets: Dict[BucketKey, deque] = {}
        self._compiled: "OrderedDict[BucketKey, Callable]" = OrderedDict()
        self._results: Dict[int, GenResult] = {}
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
                    for _, r in dq:
                        self._results[r.request_id] = GenResult(
                            r.request_id, None, 0.0, error="engine stopped")
                self._buckets.clear()
            self._lock.notify_all()
        if self._thread:
            self._thread.join()
            self._thread = None

    def submit(self, req: GenRequest):
        if not isinstance(req.steps, (int, np.integer)) or req.steps <= 0:
            raise ValueError(f"request {req.request_id}: steps must be a "
                             f"positive int, got {req.steps!r}")
        key = self._bucket_key(req)
        with self._lock:
            if self._stop:
                raise RuntimeError("engine is stopped")
            self._buckets.setdefault(key, deque()).append((time.time(), req))
            self._lock.notify_all()

    def result(self, request_id: int, timeout: float = 3600.0) -> GenResult:
        deadline = time.time() + timeout
        with self._lock:
            while request_id not in self._results:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"request {request_id}")
                self._lock.wait(timeout=remaining)
            res = self._results.pop(request_id)
        if res.error is not None:
            raise RuntimeError(f"request {request_id} failed: {res.error}")
        return res

    # -- batching loop ----------------------------------------------------------

    def _bucket_key(self, req: GenRequest) -> BucketKey:
        return (tuple(req.latent_shape), int(req.steps),
                tuple(np.shape(req.txt)))

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

    def _sampler(self, key: BucketKey) -> Callable:
        fn = self._compiled.get(key)
        if fn is None:
            fn = self._factory(key[0], key[1])
            self._compiled[key] = fn
            while len(self._compiled) > self.max_compiled:
                self._compiled.popitem(last=False)
        self._compiled.move_to_end(key)
        return fn

    def _serve(self, key: BucketKey, batch: List[Tuple[float, GenRequest]]):
        t0 = time.time()
        lat, err = None, None
        try:
            fn = self._sampler(key)
            noise = torch.stack([request_noise(r.seed, key[0], self.device)
                                 for _, r in batch])
            txt = torch.from_numpy(np.stack([np.asarray(r.txt, np.float32)
                                             for _, r in batch]))
            seeds = [r.seed for _, r in batch]
            out = fn(noise, txt.to(self.device), seeds)
            lat = out.float().cpu().numpy()
        except Exception as e:  # noqa: BLE001 — fail the batch, not the engine
            log.exception("bucket %s batch failed", key)
            err = repr(e)
        now = time.time()
        with self._lock:
            bi = self._batches_served
            self._batches_served += 1
            for i, (t_enq, r) in enumerate(batch):
                self._results[r.request_id] = GenResult(
                    r.request_id, None if err else lat[i], now - t0,
                    error=err, batch_index=bi, latency_s=now - t_enq)
            self._lock.notify_all()
        log.info("served bucket %s batch of %d in %.2fs", key, len(batch),
                 now - t0)

    def _loop(self):
        while True:
            key, batch = self._take_batch()
            if key is None:
                return
            self._serve(key, batch)

"""Front-door router over N DiffusionEngine replicas (DESIGN.md §15.4).

One process can hold several engine replicas; on one card they share the
loaded model, the device and the process's caches, each with its own
worker thread (the launcher's ``--replicas N``).  The router is the
admission point in front of the engines:

  * **load balancing** — submit routes to the healthy replica with the
    shallowest queue (queue-depth accounting via ``engine.pending()``
    plus the router's own in-flight ledger, so bursts don't all land on
    the replica whose queue the OS scheduler drained first);
  * **shed propagation** — a replica's admission control may shed
    (:class:`~repro_torch.serving.slo.ShedError`); the router then tries the
    other replicas (a request infeasible on a deep queue may be
    feasible on a shallow one) and only sheds fleet-wide when every
    healthy replica refuses;
  * **failover** — :meth:`fail_replica` (or a dead engine discovered at
    submit) drains the failed replica and *requeues* every request it
    had accepted but not successfully served onto the survivors, so a
    replica loss costs retries, not lost requests; blocked
    :meth:`result` waits and :meth:`stream` consumers both follow the
    request to its new replica.

The router keeps the original :class:`~repro_torch.serving.engine.
GenRequest` for every in-flight request — requeue is replay, which is
safe because generation is deterministic in (seed, txt, bucket): a
request served twice returns the same latents (bit for bit when its
batch has the same members).  With a
:class:`~repro_torch.serving.journal.CheckpointStore` attached (DESIGN.md
§18), requeue is *resume* instead of replay: the latest chunk-boundary
checkpoint is snapshotted onto the request at requeue time (so a zombie
batch on the dead replica racing newer writes cannot change what the
survivor serves) and the survivor picks up mid-flight through the
engine's resume path: the same latents, only the remaining steps paid.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.serving.engine import (DiffusionEngine, GenRequest,
                                        GenResult, is_failover_error)
from repro_torch.serving.slo import ShedError
from repro_torch.utils.logging import get_logger

log = get_logger("serve.router")

__all__ = ["Router"]


class Router:
    """Load-balancing front door over ``replicas`` (started/stopped as a
    group).  All public methods are thread-safe."""

    def __init__(self, replicas: List[DiffusionEngine],
                 probe_interval_s: Optional[float] = None,
                 checkpoint_store=None):
        if not replicas:
            raise ValueError("need at least one engine replica")
        self._replicas = list(replicas)
        self._healthy = [True] * len(replicas)
        # Shared chunk-boundary checkpoint store (DESIGN.md §18): when
        # set, failover hands the survivor the latest checkpoint
        # instead of replaying from step 0.
        self._store = checkpoint_store
        self.resumed_count = 0
        self.resumed_from_step = 0
        # rid -> chunks already delivered by the replica that wrote the
        # checkpoint the current assignment resumed from; the stream
        # dedup baseline (a resumed replica only emits the *remaining*
        # chunks, so plain skip-counting would swallow real ones).
        self._resume_base: Dict[int, int] = {}
        # Health probing (§17.4): every probe_interval_s the router
        # re-checks downed replicas and re-admits any whose engine is
        # healthy again (externally restarted via engine.start()).
        # None = no probe thread; probe_health() can still be called
        # manually.
        self.probe_interval_s = probe_interval_s
        self.readmitted_count = 0
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        # rid -> replica index currently responsible for the request
        self._assigned: Dict[int, int] = {}
        # rid -> original request, kept until result() hands it out so
        # failover can requeue verbatim
        self._requests: Dict[int, GenRequest] = {}
        self._inflight = [0] * len(replicas)
        self.shed_count = 0
        self.requeued_count = 0
        self._lock = threading.Lock()
        # Serializes requeue decisions: result() waiters, stream
        # consumers, and fail_replica()/_mark_down all race to move a
        # request off a dead replica; without this two of them can
        # submit the same request twice.  Always acquired before
        # self._lock, never while holding it.
        self._failover_lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        with self._lock:
            self._healthy = [True] * len(self._replicas)
        for eng in self._replicas:
            eng.start()
        if self.probe_interval_s is not None:
            self._probe_stop.clear()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, daemon=True)
            self._probe_thread.start()

    def stop(self, drain: bool = True):
        # Stop the probe thread FIRST: marking replicas down below must
        # not race a probe re-admitting them.
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join()
            self._probe_thread = None
        # Claim every still-healthy replica under the lock (marking it
        # down) so a concurrent fail_replica()/_mark_down cannot stop
        # the same engine twice or stop a just-downed replica with
        # drain=True; the engine.stop calls themselves stay outside the
        # lock so submitters are never blocked behind a drain.
        with self._lock:
            to_stop = [i for i, h in enumerate(self._healthy) if h]
            for i in to_stop:
                self._healthy[i] = False
        for i in to_stop:
            self._replicas[i].stop(drain=drain)

    def healthy_replicas(self) -> List[int]:
        with self._lock:
            return [i for i, h in enumerate(self._healthy)
                    if h and self._replicas[i].healthy()]

    def depths(self) -> Dict[int, int]:
        """Per-replica load: queued + router-tracked in-flight."""
        with self._lock:
            return {i: self._replicas[i].pending() + self._inflight[i]
                    for i, h in enumerate(self._healthy) if h}

    # -- request path ---------------------------------------------------------

    def submit(self, req: GenRequest) -> int:
        """Route to the shallowest healthy replica; returns the replica
        index.  Raises :class:`ShedError` only when *every* healthy
        replica sheds the request, RuntimeError when none is healthy."""
        last_shed: Optional[ShedError] = None
        for idx in self._by_depth():
            try:
                self._replicas[idx].submit(req)
            except ShedError as e:
                last_shed = e
                continue
            except RuntimeError:
                # replica died between the health check and the submit —
                # mark it down and keep trying survivors
                self._mark_down(idx)
                continue
            with self._lock:
                self._assigned[req.request_id] = idx
                self._requests[req.request_id] = req
                self._inflight[idx] += 1
            return idx
        if last_shed is not None:
            with self._lock:
                self.shed_count += 1
            raise last_shed
        raise RuntimeError("no healthy replica accepted the request")

    def result(self, request_id: int, timeout: float = 3600.0) -> GenResult:
        """Wait for the request's result, following it across failovers:
        if the responsible replica dies (its engine errors the request
        with "engine stopped"), the request is requeued to a survivor
        and the wait continues against the new assignment.

        On TimeoutError the ledger entry is kept — deliberately — so
        the caller can retry ``result()`` and still reach the request.
        A caller that gives up for good must call :meth:`forget` to
        release the entry, otherwise the replica's in-flight count
        stays inflated and skews least-loaded routing."""
        deadline = time.time() + timeout
        while True:
            with self._lock:
                idx = self._assigned.get(request_id)
            if idx is None:
                raise KeyError(f"request {request_id} was never routed "
                               "(or its result was already consumed)")
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError(f"request {request_id}")
            try:
                res = self._replicas[idx].result(request_id,
                                                 timeout=remaining)
            except RuntimeError as e:
                if is_failover_error(e):
                    # the replica died under this request: requeue to a
                    # survivor and keep waiting — unless no survivor
                    # would take it, then surface the original error
                    self._requeue_one(request_id, dead=idx)
                    with self._lock:
                        moved = self._assigned.get(request_id) != idx
                    if moved:
                        continue
                self.forget(request_id)
                raise
            self.forget(request_id)
            return res

    def stream(self, request_id: int,
               timeout: float = 3600.0) -> Iterator[np.ndarray]:
        """Chunk stream for the request, following it across failovers:
        each time the replica's stream ends (cleanly or with an error)
        while the assignment has moved to a survivor, the stream is
        replayed against the new replica — replay is deterministic
        (module docstring), so already-delivered chunks are skipped and
        the consumer sees one contiguous chunk sequence."""
        with self._lock:
            if request_id not in self._assigned:
                raise KeyError(f"request {request_id} was never routed")

        def _chunks():
            delivered = 0
            while True:
                with self._lock:
                    idx = self._assigned.get(request_id)
                    # A checkpointed-resume assignment emits only the
                    # chunks after its resume point, so count its first
                    # chunk as (base + 1), not 1 (§18).
                    base = self._resume_base.get(request_id, 0)
                if idx is None:
                    return  # result already consumed; nothing to stream
                moved = False
                try:
                    seen = base
                    for chunk in self._replicas[idx].stream(
                            request_id, timeout=timeout):
                        seen += 1
                        if seen <= delivered:
                            continue  # replayed chunk from before failover
                        delivered = seen
                        yield chunk
                except (RuntimeError, TimeoutError):
                    # Stalled replica: if the request moved (failover
                    # requeued it), chase it; otherwise surface.
                    with self._lock:
                        moved = self._assigned.get(request_id) \
                            not in (None, idx)
                    if not moved:
                        raise
                if not moved:
                    # Clean termination — but the terminating record may
                    # be a dead engine's "engine stopped" error (the
                    # consumer can wake before fail_replica's own
                    # requeue loop runs), so requeue like result() does
                    # and only finish if the request truly stays here.
                    rec = self._replicas[idx].peek_result(request_id)
                    if (rec is not None and rec.error is not None
                            and is_failover_error(rec.error)):
                        self._requeue_one(request_id, dead=idx)
                    with self._lock:
                        if self._assigned.get(request_id) in (None, idx):
                            return

        return _chunks()

    def forget(self, request_id: int):
        """Release the ledger entry for a request the caller has
        abandoned (e.g. after giving up on a ``result()`` timeout).
        Idempotent; without this the assigned replica's in-flight count
        stays inflated and skews least-loaded routing."""
        with self._lock:
            idx = self._assigned.pop(request_id, None)
            self._requests.pop(request_id, None)
            self._resume_base.pop(request_id, None)
            if idx is not None:
                self._inflight[idx] = max(self._inflight[idx] - 1, 0)

    # -- failover -------------------------------------------------------------

    def fail_replica(self, idx: int):
        """Take replica ``idx`` out of rotation: mark it down, requeue
        everything it had accepted but not yet served onto the
        survivors, then stop it without drain.  Requeue comes BEFORE
        the stop on purpose: ``engine.stop`` joins the batcher thread,
        which waits out the in-flight batch; requeue-first treats that
        batch as the zombie it would be on a dead host, and its late
        results and chunks are superseded by the reassignment (stream
        dedup drops its duplicate chunks).  On one card the zombie
        batch keeps the device busy while the survivor serves."""
        with self._lock:
            was_healthy = self._healthy[idx]
            self._healthy[idx] = False
        moved = 0
        for rid in self._assigned_to(idx):
            res = self._replicas[idx].peek_result(rid)
            if res is not None and res.error is None:
                continue  # served before the failure; result() will find it
            self._requeue_one(rid, dead=idx)
            moved += 1
        log.info("replica %d failed: requeued %d request(s) onto %s",
                 idx, moved, self.healthy_replicas())
        if was_healthy:
            self._replicas[idx].stop(drain=False)

    def probe_health(self) -> List[int]:
        """Re-admit downed replicas whose engine reports healthy again
        (restarted externally via ``engine.start()``).  Returns the
        re-admitted indices.  A watchdog-tripped or failed replica stays
        down until someone actually restarts its engine — the probe
        verifies recovery, it does not cause it."""
        readmitted = []
        with self._lock:
            for i, h in enumerate(self._healthy):
                if not h and self._replicas[i].healthy():
                    self._healthy[i] = True
                    self.readmitted_count += 1
                    readmitted.append(i)
        for i in readmitted:
            log.info("replica %d recovered: re-admitted to rotation", i)
        return readmitted

    def _probe_loop(self):
        while not self._probe_stop.wait(self.probe_interval_s):
            try:
                self.probe_health()
            except Exception:  # noqa: BLE001 — probing must not die
                log.exception("health probe failed")

    def metrics(self) -> Dict[str, int]:
        m = {"router_shed_count": self.shed_count,
             "router_requeued": self.requeued_count,
             "router_readmitted": self.readmitted_count,
             "router_resumed": self.resumed_count,
             "router_resumed_from_step": self.resumed_from_step}
        for i, eng in enumerate(self._replicas):
            for k, v in eng.metrics().items():
                m[f"replica{i}_{k}"] = v
        return m

    # -- internals ------------------------------------------------------------

    def _by_depth(self) -> List[int]:
        depths = self.depths()
        alive = [i for i in depths if self._replicas[i].healthy()]
        return sorted(alive, key=lambda i: depths[i])

    def _assigned_to(self, idx: int) -> List[int]:
        with self._lock:
            return [rid for rid, i in self._assigned.items() if i == idx]

    def _mark_down(self, idx: int):
        with self._lock:
            was = self._healthy[idx]
            self._healthy[idx] = False
        if was:
            log.warning("replica %d is down; draining its requests", idx)
            for rid in self._assigned_to(idx):
                res = self._replicas[idx].peek_result(rid)
                if res is None or res.error is not None:
                    self._requeue_one(rid, dead=idx)

    def _with_checkpoint(self, req: GenRequest) -> GenRequest:
        """Snapshot the latest chunk-boundary checkpoint onto the
        request (DESIGN.md §18).  Read once at requeue time under the
        failover lock: a zombie batch on the dead replica may keep
        writing newer checkpoints, but the survivor serves exactly this
        snapshot.  The request stays as it is (replay from step 0, or
        its earlier resume) when there is no store, no streaming
        cadence, or no usable checkpoint: one off a chunk boundary, at
        the final step, or not past the resume the request has."""
        if self._store is None or not req.stream_every:
            return req
        ck = self._store.get(req.request_id)
        if not ck:
            return req
        step = int(ck.get("step") or 0)
        prev = int(req.resume["step"]) if req.resume else 0
        if (step <= prev or step >= req.steps
                or step % req.stream_every != 0):
            return req
        return dataclasses.replace(
            req, resume={"step": step, "x": ck["x"],
                         "dstate": ck.get("dstate")})

    def _requeue_one(self, request_id: int, dead: int):
        with self._failover_lock:
            with self._lock:
                req = self._requests.get(request_id)
                if req is None or self._assigned.get(request_id) != dead:
                    return  # already moved or consumed
                self._inflight[dead] = max(self._inflight[dead] - 1, 0)
            req = self._with_checkpoint(req)
            for idx in self._by_depth():
                if idx == dead:
                    continue
                try:
                    self._replicas[idx].submit(req)
                except (ShedError, RuntimeError):
                    continue
                with self._lock:
                    self._assigned[request_id] = idx
                    self._requests[request_id] = req
                    self._inflight[idx] += 1
                    self.requeued_count += 1
                    if req.resume is not None:
                        step = int(req.resume["step"])
                        self.resumed_count += 1
                        self.resumed_from_step = max(
                            self.resumed_from_step, step)
                        self._resume_base[request_id] = (
                            step // req.stream_every)
                log.info("request %d requeued from replica %d to %d%s",
                         request_id, dead, idx,
                         f" (resuming from step {req.resume['step']})"
                         if req.resume else "")
                return
            # no survivor took it: leave the assignment pointing at the
            # dead replica so result() surfaces the original error
            log.error("request %d could not be requeued off replica %d",
                      request_id, dead)

"""Deterministic fault injection — the chaos harness (DESIGN.md §17.3).

The guardrail / watchdog / quarantine machinery is only trustworthy if
it is *exercised*, so this module turns failure modes into a reproducible
spec instead of an outage: a seeded, counted plan of faults that the
dispatch layer, the engine, and the serving drivers consult at
well-defined points.  Install via ``python -m repro_torch.launch.serve
--inject-faults SPEC`` or the ``REPRO_FAULTS`` environment variable (the
JAX package's, so one spec drives either launcher).

Spec grammar (``;``-separated faults, ``,``-separated ``key=value``
params; ints/floats parsed, everything else kept as string)::

    REPRO_FAULTS="attn_nan:step=1;kill_replica:after=1"
    REPRO_FAULTS="seed=7;raise:count=2,msg=transient;poison:rid=3"

Fault kinds and where they fire:

  ``attn_nan``       ``attention_dispatch``: the attention output of
                     every *non-dense* backend is flipped to NaN at
                     denoising step ``step`` (default 0).  Scoped
                     to sparse backends on purpose — the degradation
                     ladder's dense rung must clear the fault, the way
                     a real sparse-kernel bug would.
  ``artifact_corrupt``  engine loop, after ``after`` served batches
                     (default 1): garbage bytes are written over the
                     pattern artifact file and the in-memory install is
                     dropped, so the next load takes the
                     warn-and-regenerate path (DESIGN.md §16).
  ``hang``           engine worker, before the sampler runs: sleeps
                     ``seconds`` (default 3600) — watchdog fodder.
  ``raise``          engine worker: raises RuntimeError(``msg``) —
                     transient, retry-with-backoff outlasts ``count``.
  ``poison``         engine worker: raises whenever request ``rid`` is
                     in the batch, every time (``count=-1`` default) —
                     the bisection quarantine's deterministic prey.
  ``kill_replica``   the launcher: fail a router replica after
                     ``after`` completed results.
  ``crash``          the launcher: SIGKILL the whole serving process
                     after ``after`` completed results — a hard kill,
                     no drain, no clean-shutdown marker (DESIGN.md
                     §18).  With ``wait_ckpt=1`` (default) the launcher
                     first waits for at least one in-flight request's
                     chunk checkpoint to land, so "mid-generation" is
                     deterministic; the restart drill then recovers
                     from the journal with ``--resume``.

``count`` (default 1; ``-1`` = unlimited) bounds how many times a
host-level fault fires; ``attn_nan`` stays armed while installed (the
dense rung clears it) and counts each call it flipped.  All arming
decisions are plain counters under a lock — no wall clock, no RNG — so a spec
replays identically; ``seed`` is carried for fault kinds that may want
randomized placement later and is mixed into nothing today.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

from repro_torch.utils.logging import get_logger

log = get_logger("serve.faults")

__all__ = ["ENV_VAR", "FaultPlan", "FaultSpec", "active_faults",
           "clear_faults", "install_faults", "install_from_env",
           "parse_faults"]

ENV_VAR = "REPRO_FAULTS"

_KINDS = ("attn_nan", "artifact_corrupt", "hang", "raise", "poison",
          "kill_replica", "crash")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    count: int = 1  # -1 = unlimited
    params: Dict[str, object] = dataclasses.field(default_factory=dict)

    def param(self, key: str, default=None):
        return self.params.get(key, default)


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def parse_faults(spec: str) -> "FaultPlan":
    """Parse the spec grammar (module docstring) into a
    :class:`FaultPlan`.  Raises ValueError on unknown fault kinds or
    malformed segments — a chaos drill with a typo'd spec must fail
    loudly, not silently inject nothing."""
    specs: List[FaultSpec] = []
    seed = 0
    for seg in (s.strip() for s in spec.split(";")):
        if not seg:
            continue
        if seg.startswith("seed="):
            seed = int(seg.split("=", 1)[1])
            continue
        kind, _, rest = seg.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {spec!r}; known: {_KINDS}")
        params: Dict[str, object] = {}
        for pair in (p.strip() for p in rest.split(",") if p.strip()):
            if "=" not in pair:
                raise ValueError(
                    f"malformed fault param {pair!r} in {seg!r} "
                    "(expected key=value)")
            k, v = pair.split("=", 1)
            params[k.strip()] = _coerce(v.strip())
        count = int(params.pop("count", -1 if kind == "poison" else 1))
        specs.append(FaultSpec(kind=kind, count=count, params=params))
    return FaultPlan(specs, seed=seed)


class FaultPlan:
    """A parsed fault spec plus its firing counters (thread-safe)."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._remaining = {id(s): s.count for s in self.specs}
        self._fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    def spec(self, kind: str) -> Optional[FaultSpec]:
        """Static lookup (trace-time arming check) — does not consume."""
        for s in self.specs:
            if s.kind == kind:
                return s
        return None

    def take(self, kind: str) -> Optional[FaultSpec]:
        """Consume one firing of ``kind`` if any remain; None otherwise."""
        with self._lock:
            for s in self.specs:
                if s.kind != kind:
                    continue
                left = self._remaining[id(s)]
                if left == 0:
                    continue
                if left > 0:
                    self._remaining[id(s)] = left - 1
                self._fired[kind] = self._fired.get(kind, 0) + 1
                return s
        return None

    def note_fired(self, kind: str) -> None:
        """Count a firing decided elsewhere (``attn_nan`` flipping one
        dispatch call's output)."""
        with self._lock:
            self._fired[kind] = self._fired.get(kind, 0) + 1

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {f"fault_{k}": v for k, v in sorted(self._fired.items())}

    # -- engine-worker hooks (called inside the engine's _run_batch) -------

    def maybe_hang(self) -> bool:
        s = self.take("hang")
        if s is None:
            return False
        seconds = float(s.param("seconds", 3600.0))
        log.warning("fault injection: hanging sampler for %.1fs", seconds)
        time.sleep(seconds)
        return True

    def maybe_raise(self) -> None:
        s = self.take("raise")
        if s is not None:
            raise RuntimeError(
                f"injected fault: {s.param('msg', 'transient worker error')}")

    def check_poison(self, request_ids) -> None:
        s = self.spec("poison")
        if s is None:
            return
        rid = s.param("rid")
        if rid in list(request_ids) and self.take("poison") is not None:
            raise RuntimeError(f"injected poison fault: request {rid}")

    def maybe_corrupt_artifact(self, batches_served: int) -> bool:
        s = self.spec("artifact_corrupt")
        if s is None or batches_served < int(s.param("after", 1)):
            return False
        if self.take("artifact_corrupt") is None:
            return False
        from repro_torch.core import patterns

        path = patterns.pattern_artifact_path()
        try:
            with open(path, "wb") as f:
                f.write(b"\x00corrupt-by-fault-injection\xff{")
        except OSError as e:  # no artifact file to corrupt: still drop RAM
            log.warning("fault injection: could not corrupt %s (%s)",
                        path, e)
        patterns.set_active_artifact(None)
        log.warning("fault injection: corrupted pattern artifact at %s",
                    path)
        return True


# ---------------------------------------------------------------------------
# Process-wide install (mirrors dispatch's active-mesh idiom)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def install_faults(plan) -> Optional[FaultPlan]:
    """Install a :class:`FaultPlan` (or a spec string) process-wide;
    returns the previous plan.  ``install_faults(None)`` uninstalls."""
    global _ACTIVE
    if isinstance(plan, str):
        plan = parse_faults(plan)
    prev, _ACTIVE = _ACTIVE, plan
    if plan is not None:
        log.warning("fault injection armed: %s",
                    [(s.kind, s.count, s.params) for s in plan.specs])
    return prev


def clear_faults() -> None:
    install_faults(None)


def active_faults() -> Optional[FaultPlan]:
    return _ACTIVE


def install_from_env() -> Optional[FaultPlan]:
    """Arm ``REPRO_FAULTS`` if set (no-op otherwise); returns the
    installed plan."""
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return None
    install_faults(parse_faults(spec))
    return _ACTIVE

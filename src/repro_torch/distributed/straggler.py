"""Straggler mitigation: a bounded-staleness barrier policy (the JAX
package's ``distributed/straggler.py``, plain Python, ported as it is).

At thousands of hosts the slowest worker sets the step time; the standard
mitigations are (a) backup workers, (b) bounded staleness (skip a host's
contribution if it exceeds a deadline, rescale the gradient), (c)
checkpoint-evict-replace.  This module implements policy (b) as a
deterministic, unit-testable state machine a launcher consults each
step; the policy's decisions are what the tests assert on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class StragglerPolicy:
    """Skip hosts slower than ``deadline_factor`` x median step time, but
    never drop more than ``max_skip_fraction`` of hosts, and evict hosts
    skipped ``evict_after`` consecutive steps (replace from spares)."""

    deadline_factor: float = 2.0
    max_skip_fraction: float = 0.05
    evict_after: int = 10

    def __post_init__(self):
        self.skip_streak: Dict[int, int] = {}

    def decide(self, step_times: Sequence[float]) -> Tuple[List[int], List[int]]:
        """step_times[i] = host i's reported duration for this step.
        Returns (skipped_hosts, evicted_hosts)."""
        n = len(step_times)
        ordered = sorted(step_times)
        median = ordered[n // 2]
        deadline = self.deadline_factor * median
        candidates = [i for i, t in enumerate(step_times) if t > deadline]
        max_skips = int(self.max_skip_fraction * n)
        # skip the slowest first, bounded
        candidates.sort(key=lambda i: -step_times[i])
        skipped = candidates[:max_skips]
        evicted = []
        for i in range(n):
            if i in skipped:
                self.skip_streak[i] = self.skip_streak.get(i, 0) + 1
                if self.skip_streak[i] >= self.evict_after:
                    evicted.append(i)
                    self.skip_streak[i] = 0
            else:
                self.skip_streak[i] = 0
        return skipped, evicted

    @staticmethod
    def gradient_rescale(n_hosts: int, skipped: Sequence[int]) -> float:
        """Contribution rescale so the expected gradient is unbiased when
        ``len(skipped)`` hosts' microbatches are excluded."""
        kept = n_hosts - len(skipped)
        return n_hosts / max(kept, 1)

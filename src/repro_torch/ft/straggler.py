"""Straggler detection & mitigation policy (a copy of
``repro.ft.straggler``; the port imports nothing of the JAX package).

At 1000+ nodes, slow hosts (thermal throttling, failing HBM, network
degradation) stretch every synchronous step.  The monitor keeps an EWMA of
step times; a step slower than ``threshold x`` the EWMA increments a strike
counter, and ``strikes`` consecutive slow steps trigger a mitigation action:

    "checkpoint_and_evict" — snapshot via CheckpointManager, remove the slow
    host from the next job restart (``ft.elastic``: ``downsize_batch_rules``
    checks the eviction, ``survivor_rules`` builds the smaller mesh, and the
    checkpoint restores onto it).

The tests feed it synthetic timings; the runner feeds it host step times.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Ewma:
    """Exponentially-weighted moving average over a stream of observations.

    ``value = alpha * value + (1 - alpha) * x`` — the first observation
    seeds the average.  The serving layer's admission policy and adaptive
    controller (``serve.admission``) reuse it.
    """

    alpha: float = 0.9
    value: float | None = None

    def update(self, x: float, alpha: float | None = None) -> float:
        """Fold one observation in; ``alpha`` overrides the blend for this
        sample only (the monitor's warmup uses a faster 0.5 blend)."""
        a = self.alpha if alpha is None else alpha
        self.value = x if self.value is None else a * self.value + (1 - a) * x
        return self.value


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 1.8     # step slower than 1.8x EWMA is "slow"
    strikes: int = 3           # consecutive slow steps before mitigation
    ema: float = 0.9
    warmup: int = 5            # ignore the first steps (compile, cache warm)

    _count: int = 0
    _strikes: int = 0
    _mean_ewma: Ewma | None = None

    def __post_init__(self):
        if self._mean_ewma is None:
            self._mean_ewma = Ewma(alpha=self.ema)

    def update(self, step_seconds: float, host: int = 0) -> str | None:
        """Feed one step time. Returns a mitigation action or None."""
        self._count += 1
        if self._count <= self.warmup:
            self._mean_ewma.update(step_seconds, alpha=0.5)
            return None
        slow = step_seconds > self.threshold * self.mean_step_seconds
        if slow:
            self._strikes += 1
        else:
            self._strikes = 0
            self._mean_ewma.update(step_seconds)
        if self._strikes >= self.strikes:
            self._strikes = 0
            return "checkpoint_and_evict"
        return None

    @property
    def mean_step_seconds(self) -> float:
        return self._mean_ewma.value if self._mean_ewma.value is not None \
            else 0.0

"""Load-management policies for the recon serving stack: admission control
with load shedding, and the adaptive pipelining controller (a copy of
``repro.serve.admission``; the port imports nothing of the JAX package).

Serving dies two ways under overload: the queue grows without bound
(latency collapse — every request eventually violates its deadline, but
only after burning memory and compute on work nobody will wait for), or a
partial failure takes out whole waves.  This module is the first answer:
**reject early, cheaply, and legibly**.

:class:`AdmissionPolicy` is consulted by ``RequestQueue.submit`` after
validation.  It can shed an arriving request for three structured reasons
(:class:`ShedReason`):

* ``QUEUE_FULL`` — admitting it would exceed the pending-voxel budget
  (``max_pending_voxels``), the hard bound on queue memory and backlog.
* ``DEADLINE`` — the *estimated* queue wait (pending voxels over the
  observed service rate, an :class:`~repro_torch.ft.straggler.Ewma` fed by
  the engine at every wave retire) already exceeds the request's deadline.
* ``DISPLACED`` — a higher-priority arrival evicted pending lower-priority
  tickets to make room (priority-aware shedding; off via ``displace=False``).

Shedding is a *lifecycle outcome*, never an exception: the ticket comes
back in the ``shed`` terminal state with ``shed_reason`` set, distinct from
``failed`` (invalid request / runtime error), so clients can branch on
"overloaded, retry with backoff" vs "bad request, don't".

:class:`AdaptiveController` tracks per-wave staging-vs-compute overlap with
the same EWMA the training straggler watchdog uses and tunes
``inflight_depth`` (deepen the pipeline while staging is not hidden under
compute, shrink it when it is) and the wave voxel cap (sized so one wave
costs ``target_wave_ms`` of compute; stalls halve it), both clamped to safe
bounds.  Pure host-side arithmetic — no device state, deterministic under
an injected clock, unit-testable with synthetic timings.
"""

from __future__ import annotations

import dataclasses

from repro_torch.ft.straggler import Ewma

#: wave caps snap to this grid: the smallest bucket of the executor's
#: ``DEFAULT_BUCKETS``, so a tuned cap never splits a tile of the grid
LANE = 128


class ShedReason:
    """Structured load-shedding codes recorded on ``ticket.shed_reason``."""

    QUEUE_FULL = "queue_full"          # pending-voxel budget exhausted
    DEADLINE = "deadline_unmeetable"   # est. queue wait > request deadline
    DISPLACED = "displaced_by_priority"  # evicted for a higher-priority job

    ALL = (QUEUE_FULL, DEADLINE, DISPLACED)


@dataclasses.dataclass
class AdmissionPolicy:
    """Admission gate with bounded backlog, deadline-aware rejection, and
    priority displacement.

    ``max_pending_voxels`` bounds the queue's total pending work; a request
    that would exceed it is shed (``QUEUE_FULL``) unless ``displace`` is on
    and enough strictly-lower-priority pending work can be shed
    (``DISPLACED``) to make room.  The budget must exceed the largest
    single request, or that request can never be admitted — the bound is
    deliberately hard (bounded memory is the point).

    ``deadline_ms`` is the default per-request wait budget (a ticket's own
    ``deadline_ms`` overrides it): once the observed service rate is known,
    a request whose estimated queue wait exceeds its deadline is shed
    (``DEADLINE``) instead of being queued into a guaranteed miss.  The
    rate estimate is an :class:`Ewma` over ``served_voxels / wave_seconds``
    fed by ``observe_service`` at every wave retire; until the first wave
    retires no estimate exists and the deadline check abstains.
    """

    max_pending_voxels: int | None = None
    deadline_ms: float | None = None
    displace: bool = True
    rate_alpha: float = 0.7
    _rate: Ewma | None = None

    def __post_init__(self):
        if self._rate is None:
            self._rate = Ewma(alpha=self.rate_alpha)

    # -- service-rate feedback (engine calls this at wave retire) ----------

    def observe_service(self, n_voxels: int, seconds: float) -> None:
        """Fold one retired wave's throughput into the rate estimate."""
        if n_voxels > 0 and seconds > 0:
            self._rate.update(n_voxels / seconds)

    @property
    def service_rate(self) -> float | None:
        """Observed voxels/s EWMA; None until the first wave retires."""
        return self._rate.value

    def estimated_wait_s(self, pending_voxels: int) -> float | None:
        """Predicted queue wait for work arriving behind ``pending_voxels``
        of backlog; None while the service rate is unknown."""
        if not self._rate.value:
            return None
        return pending_voxels / self._rate.value

    # -- the gate ----------------------------------------------------------

    def admit(self, ticket, n_voxels: int, queue) -> str | None:
        """Decide one arrival: None admits; a :class:`ShedReason` code sheds.

        May mutate ``queue`` (via ``shed_pending``) when displacement frees
        budget for a higher-priority arrival — in that case the arrival is
        admitted and the displaced tickets are the ones shed.
        """
        deadline = (ticket.deadline_ms if ticket.deadline_ms is not None
                    else self.deadline_ms)
        if deadline is not None:
            est = self.estimated_wait_s(queue.pending_voxels())
            if est is not None and est * 1e3 > deadline:
                return ShedReason.DEADLINE
        if (self.max_pending_voxels is not None
                and queue.pending_voxels() + n_voxels
                > self.max_pending_voxels):
            if self.displace:
                victims = self._displacement_victims(ticket, n_voxels, queue)
                if victims is not None:
                    queue.shed_pending(victims, ShedReason.DISPLACED)
                    return None
            return ShedReason.QUEUE_FULL
        return None

    def _displacement_victims(self, ticket, n_voxels: int, queue):
        """Pick pending tickets of strictly lower priority to shed so
        ``ticket`` fits the budget; None when they can't free enough.
        Victims are lowest-priority-first, newest-first within a class —
        the work least likely to be missed and the cheapest broken promise.
        """
        need = queue.pending_voxels() + n_voxels - self.max_pending_voxels
        victims, freed = [], 0
        cands = sorted((t for t in queue.pending_tickets()
                        if t.priority < ticket.priority),
                       key=lambda t: (t.priority, -t.seq))
        for t in cands:
            if freed >= need:
                break
            victims.append(t)
            freed += int(t.request.n_voxels)
        return victims if freed >= need else None


def _lane_floor(n: float, lo: int, hi: int) -> int:
    """Clamp to [lo, hi] and snap down onto the ``LANE`` grid."""
    n = max(lo, min(hi, int(n)))
    return max(lo, (n // LANE) * LANE)


@dataclasses.dataclass
class AdaptiveController:
    """Tunes ``inflight_depth`` and the wave voxel cap from observed
    per-wave staging/compute overlap, clamped to safe bounds.

    Fed once per retired wave by the engine (``observe``), it keeps three
    EWMAs — host staging seconds, compute seconds, and compute voxels/s —
    and applies two deterministic rules:

    * **depth** — pipelining exists to hide host staging under device
      compute.  While staging costs more than ``grow_ratio`` of compute,
      one extra in-flight wave buys real overlap: deepen (up to
      ``max_depth``).  Once staging is under ``shrink_ratio`` of compute
      the extra depth only adds queue latency ahead of the device: shrink
      (down to ``min_depth``).
    * **wave cap** — sized so one wave costs ``target_wave_ms`` of compute
      at the observed rate (big enough to amortize dispatch, small enough
      that a wave is a latency quantum, not a convoy), snapped to the
      ``LANE`` grid and clamped to [min_wave_voxels, max_wave_voxels].
      A stalled wave (watchdog timeout / injected slow-wave fault) halves
      the cap instead — smaller waves bound the damage a stall does while
      the EWMA recovers.

    ``target_wave_ms=None`` disables cap tuning (stalls still shrink).
    """

    min_depth: int = 1
    max_depth: int = 4
    min_wave_voxels: int = LANE
    max_wave_voxels: int = 1 << 16
    target_wave_ms: float | None = 50.0
    grow_ratio: float = 0.5
    shrink_ratio: float = 0.1
    alpha: float = 0.7
    depth: int = 2
    wave_voxels: int | None = None

    _staging: Ewma | None = None
    _compute: Ewma | None = None
    _rate: Ewma | None = None

    def __post_init__(self):
        if self.min_depth < 1 or self.max_depth < self.min_depth:
            raise ValueError(f"need 1 <= min_depth <= max_depth, got "
                             f"[{self.min_depth}, {self.max_depth}]")
        if self.min_wave_voxels < 1 or \
                self.max_wave_voxels < self.min_wave_voxels:
            raise ValueError(
                f"need 1 <= min_wave_voxels <= max_wave_voxels, got "
                f"[{self.min_wave_voxels}, {self.max_wave_voxels}]")
        self.depth = max(self.min_depth, min(self.max_depth, self.depth))
        if self.wave_voxels is not None:
            self.wave_voxels = _lane_floor(
                self.wave_voxels, self.min_wave_voxels, self.max_wave_voxels)
        for name in ("_staging", "_compute", "_rate"):
            if getattr(self, name) is None:
                setattr(self, name, Ewma(alpha=self.alpha))

    def observe(self, *, staging_s: float, compute_s: float, n_voxels: int,
                stalled: bool = False) -> tuple:
        """Fold one retired wave in; returns the tuned ``(depth,
        wave_voxels)`` (wave_voxels None while cap tuning is inactive)."""
        self._staging.update(max(staging_s, 0.0))
        self._compute.update(max(compute_s, 1e-9))
        if n_voxels > 0 and compute_s > 0:
            self._rate.update(n_voxels / compute_s)
        ratio = self._staging.value / max(self._compute.value, 1e-12)
        if ratio > self.grow_ratio and self.depth < self.max_depth:
            self.depth += 1
        elif ratio < self.shrink_ratio and self.depth > self.min_depth:
            self.depth -= 1
        if stalled:
            base = (self.wave_voxels if self.wave_voxels is not None
                    else self.max_wave_voxels)
            self.wave_voxels = _lane_floor(base // 2, self.min_wave_voxels,
                                           self.max_wave_voxels)
        elif self.target_wave_ms is not None and self._rate.value:
            want = self._rate.value * self.target_wave_ms * 1e-3
            self.wave_voxels = _lane_floor(want, self.min_wave_voxels,
                                           self.max_wave_voxels)
        return self.depth, self.wave_voxels

"""Admission layer of the recon serving stack: a persistent request queue
(a copy of ``repro.serve.queue``; the port imports nothing of the JAX
package).

A :class:`RequestQueue` outlives any single wave — requests are *admitted*
(validated once, stamped with their enqueue time) and then *scheduled* into
waves by an explicit formation policy, instead of the engine serving
whatever list one ``reconstruct`` call happened to pass.

Request lifecycle
-----------------
Every admitted request is wrapped in a :class:`QueuedRequest` ticket that
moves through ``pending -> scheduled -> done | failed | shed``:

* ``pending``   — admitted, waiting for a wave.
* ``scheduled`` — handed to the executor as part of a formed wave.
* ``done``      — assembled into a result; ``ticket.result`` is set and
  ``ticket.latency_s`` measures **enqueue-to-assembled** time (the queue
  stamps ``enqueue_t`` at admission, so queue wait is part of the latency —
  not just time-within-wave).
* ``failed``    — rejected at admission (validator) or failed during
  execution/assembly; ``ticket.error`` carries the reason.  Failures are
  lifecycle states, never exceptions thrown out of a wave: one bad request
  cannot leave its wave-mates half-served.
* ``shed``      — rejected by the *load* policy (``serve.admission``), not
  because the request is invalid: the pending-voxel budget is exhausted,
  the estimated queue wait already exceeds the request's deadline, or a
  higher-priority arrival displaced it.  ``ticket.shed_reason`` carries a
  structured :class:`~repro_torch.serve.admission.ShedReason` code so
  callers can tell "invalid, don't retry" (``failed``) from "overloaded,
  retry later" (``shed``) without string-matching ``ticket.error``.

Failed waves can also *requeue* tickets (``scheduled -> pending`` with
``ticket.retries`` incremented and ``ticket.solo`` set): the engine's
bounded-retry path re-admits untouched wave-mates of a crashed dispatch,
and ``solo`` tickets then form single-request waves so a poisoned request
cannot take mates down with it twice.

Wave formation policy
---------------------
``form_wave`` pops the next wave under three knobs:

* ``max_wave_voxels`` — a wave closes when admitting the next request would
  exceed this many voxels (a single oversized request still forms its own
  wave — nothing can starve).
* ``max_wait_ms``     — a deadline from *enqueue*: once the oldest pending
  ticket has waited this long, the wave is due even if small.  ``None``
  disables the deadline trigger (waves form only on the voxel trigger or an
  explicit flush).
* priority          — higher ``priority`` tickets schedule first; ties are
  FIFO in admission order.  Packing never skips over a request that does
  not fit (no starvation by reordering within a priority class), and a
  ticket past its ``max_wait_ms`` deadline is promoted to lead the next
  wave regardless of priority (no starvation by sustained
  higher-priority load).

The queue is time-source-injectable (``clock=``) so deadline behaviour is
deterministically testable.  It holds no device state at all — staging and
compute live in ``serve.executor``; composition lives in ``serve.recon``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


class RequestState:
    """Lifecycle states of a :class:`QueuedRequest` ticket."""

    PENDING = "pending"
    SCHEDULED = "scheduled"
    DONE = "done"
    FAILED = "failed"
    SHED = "shed"

    #: states a ticket can never leave (every admitted ticket must end in
    #: exactly one of these — the chaos-suite property)
    TERMINAL = (DONE, FAILED, SHED)


@dataclasses.dataclass(eq=False)
class QueuedRequest:
    """One admitted request's ticket through the queue lifecycle.

    ``request`` is duck-typed: the queue only reads ``n_voxels`` and
    ``request_id`` (``serve.recon.ReconRequest`` in production).
    """

    request: object
    priority: int
    seq: int              # admission counter: the FIFO tiebreak
    enqueue_t: float
    state: str = RequestState.PENDING
    error: str | None = None
    result: object | None = None
    done_t: float | None = None
    #: structured load-shedding code (None unless state == "shed")
    shed_reason: str | None = None
    #: per-request deadline consulted by the admission policy (ms from
    #: enqueue); None falls back to the policy default
    deadline_ms: float | None = None
    #: times this ticket was requeued after a failed wave (bounded by the
    #: engine's max_retries)
    retries: int = 0
    #: requeued tickets dispatch in single-request waves: a retry must not
    #: share a wave (and its blast radius) with fresh requests
    solo: bool = False

    @property
    def latency_s(self) -> float | None:
        """Enqueue-to-assembled latency; None until the ticket is done."""
        if self.done_t is None:
            return None
        return self.done_t - self.enqueue_t


class RequestQueue:
    """Persistent admission queue with wave-formation policy.

    ``validator`` (optional) maps a request to an error string (or None);
    invalid requests are returned as ``failed`` tickets and never admitted,
    so they cannot poison a wave.

    ``admission`` (optional, a ``serve.admission.AdmissionPolicy``) is the
    *load* gate consulted after validation: it may shed the arriving ticket
    (returned already ``shed`` with a structured ``shed_reason``) or
    displace pending lower-priority tickets to make room.  Validation
    answers "is this request well-formed?"; admission answers "can we
    afford to serve it right now?" — the two rejections stay distinct
    lifecycle outcomes.
    """

    def __init__(self, *, max_wave_voxels: int | None = None,
                 max_wait_ms: float | None = None,
                 validator: Callable[[object], str | None] | None = None,
                 admission=None,
                 clock: Callable[[], float] = time.perf_counter):
        if max_wave_voxels is not None and max_wave_voxels <= 0:
            raise ValueError(f"max_wave_voxels must be positive or None, "
                             f"got {max_wave_voxels}")
        if max_wait_ms is not None and max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0 or None, "
                             f"got {max_wait_ms}")
        self.max_wave_voxels = max_wave_voxels
        self.max_wait_ms = max_wait_ms
        self._validator = validator
        self._admission = admission
        self._clock = clock
        self._pending: list[QueuedRequest] = []
        self._sorted = True  # lazily re-sorted on the next form_wave
        # running totals so wave_due is O(1) per poll: the voxel sum, and
        # the oldest pending ticket (enqueue_t is monotonic in seq, so it
        # only needs recomputing when the current oldest is popped)
        self._pending_voxels = 0
        self._oldest: QueuedRequest | None = None
        self._seq = 0
        self.n_rejected = 0
        self.n_shed = 0

    # -- admission ---------------------------------------------------------

    def submit(self, request, *, priority: int = 0, validate: bool = True,
               deadline_ms: float | None = None) -> QueuedRequest:
        """Admit one request; returns its lifecycle ticket.

        Validation happens here, once, at admission: a rejected request
        comes back already ``failed`` (with ``error`` set) and is *not*
        queued — admission of one request never raises and never affects
        requests already pending.  Callers that already validated (the
        engine's all-or-nothing batch path) pass ``validate=False`` to
        avoid paying the mask-sum check twice.

        When an admission policy is installed, a *valid* request can still
        come back ``shed`` (``shed_reason`` set) — the load-shedding
        outcome; ``deadline_ms`` is this request's wait budget for the
        policy's deadline-aware rejection (None: the policy default).
        """
        ticket = QueuedRequest(request=request, priority=int(priority),
                               seq=self._seq, enqueue_t=self._clock(),
                               deadline_ms=deadline_ms)
        self._seq += 1
        if validate and self._validator is not None:
            try:
                err = self._validator(request)
            except Exception as e:
                # a crashing validator must not break admission
                err = f"validator error: {type(e).__name__}: {e}"
            if err is not None:
                ticket.state = RequestState.FAILED
                ticket.error = err
                self.n_rejected += 1
                return ticket
        try:
            nv = int(ticket.request.n_voxels)
        except Exception as e:
            # never-raises holds even for validator-less queues fed
            # malformed duck-typed requests
            ticket.state = RequestState.FAILED
            ticket.error = (f"request has no usable n_voxels: "
                            f"{type(e).__name__}: {e}")
            self.n_rejected += 1
            return ticket
        if self._admission is not None:
            try:
                reason = self._admission.admit(ticket, nv, self)
            except Exception as e:
                # a crashing policy must not break admission either; fail
                # open (admit) would silently disable load shedding, so
                # shed with the error recorded instead
                reason = f"admission policy error: {type(e).__name__}: {e}"
            if reason is not None:
                ticket.state = RequestState.SHED
                ticket.shed_reason = reason
                ticket.error = f"shed at admission: {reason}"
                self.n_shed += 1
                return ticket
        self._pending.append(ticket)
        self._pending_voxels += nv
        if self._oldest is None:  # new tickets are never older
            self._oldest = ticket
        self._sorted = False
        return ticket

    def requeue(self, ticket: QueuedRequest) -> None:
        """Return a previously scheduled ticket to the pending pool.

        The engine's bounded-retry path: wave-mates of a crashed dispatch
        come back here (``retries`` already incremented by the engine) and
        keep their original ``seq``/``enqueue_t``, so FIFO position and
        latency accounting survive the retry.
        """
        if ticket.state != RequestState.SCHEDULED:
            raise ValueError(f"only scheduled tickets can requeue, got "
                             f"{ticket.state!r}")
        ticket.state = RequestState.PENDING
        self._pending.append(ticket)
        self._pending_voxels += int(ticket.request.n_voxels)
        self._sorted = False
        # enqueue_t is monotone in seq, so min-seq is again the oldest
        if self._oldest is None or ticket.seq < self._oldest.seq:
            self._oldest = ticket

    def shed_pending(self, tickets: list, reason: str) -> None:
        """Shed already-pending tickets (the displacement path): each moves
        to the ``shed`` terminal state with ``reason`` recorded."""
        ids = {id(t) for t in tickets}
        if not ids:
            return
        self._pending = [t for t in self._pending if id(t) not in ids]
        for t in tickets:
            self._pending_voxels -= int(t.request.n_voxels)
            t.state = RequestState.SHED
            t.shed_reason = reason
            t.error = f"shed while pending: {reason}"
            self.n_shed += 1
        if self._oldest is not None and id(self._oldest) in ids:
            self._oldest = (min(self._pending, key=lambda t: t.seq)
                            if self._pending else None)

    def pending_tickets(self) -> tuple:
        """Read-only view of the pending pool (admission policies inspect
        priorities/sizes here to pick displacement victims)."""
        return tuple(self._pending)

    # -- introspection -----------------------------------------------------

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def __len__(self) -> int:
        return len(self._pending)

    def pending_voxels(self) -> int:
        return self._pending_voxels

    def oldest_wait_s(self, now: float | None = None) -> float:
        """Seconds the longest-waiting pending ticket has been queued."""
        if self._oldest is None:
            return 0.0
        now = self._clock() if now is None else now
        return now - self._oldest.enqueue_t

    def wave_due(self, now: float | None = None) -> bool:
        """True when the formation policy says the next wave should go:
        the voxel budget is reached, or the oldest ticket hit its deadline."""
        if not self._pending:
            return False
        if (self.max_wave_voxels is not None
                and self.pending_voxels() >= self.max_wave_voxels):
            return True
        if self.max_wait_ms is not None:
            return self.oldest_wait_s(now) * 1e3 >= self.max_wait_ms
        return False

    # -- wave formation ----------------------------------------------------

    def form_wave(self, *, now: float | None = None,
                  flush: bool = False) -> list[QueuedRequest]:
        """Pop the next wave of tickets (marked ``scheduled``), or ``[]``.

        Without ``flush`` a wave forms only when :meth:`wave_due`; with it
        (the drain path) the policy triggers are bypassed but the voxel cap
        still bounds each wave.  Order is (-priority, admission seq); the
        cap closes the wave at the first request that does not fit — except
        that a wave always takes at least one request, so an oversized
        request is served alone rather than starved.  Deadline promotion
        guards the other starvation mode: once the oldest pending ticket
        exceeds ``max_wait_ms``, it leads the next wave regardless of
        priority, so sustained higher-priority load cannot park it forever.
        """
        if not self._pending:
            return []
        now = self._clock() if now is None else now
        if not flush and not self.wave_due(now):
            return []
        if not self._sorted:
            # one sort per backlog change, not per wave: waves pop a prefix,
            # which keeps the remainder ordered for the next form_wave
            self._pending.sort(key=lambda t: (-t.priority, t.seq))
            self._sorted = True
        cand = self._pending
        promoted = (self.max_wait_ms is not None
                    and self.oldest_wait_s(now) * 1e3 >= self.max_wait_ms
                    and cand[0] is not self._oldest)
        if promoted:
            cand = [self._oldest] + [t for t in cand
                                     if t is not self._oldest]
        wave: list[QueuedRequest] = []
        voxels = 0
        for ticket in cand:
            nv = ticket.request.n_voxels
            # solo (retry) tickets ride alone: a requeued request must not
            # share its blast radius with fresh wave-mates again
            if wave and (ticket.solo or wave[0].solo):
                break
            if (wave and self.max_wave_voxels is not None
                    and voxels + nv > self.max_wave_voxels):
                break
            wave.append(ticket)
            voxels += nv
        if promoted:
            # the wave is no longer a prefix of the sorted pending list;
            # removing a subset of a sorted list keeps it sorted
            ids = {id(t) for t in wave}
            self._pending = [t for t in self._pending if id(t) not in ids]
        else:
            self._pending = self._pending[len(wave):]
        self._pending_voxels -= voxels
        for ticket in wave:
            ticket.state = RequestState.SCHEDULED
        if self._oldest in wave:  # amortized: recompute only when popped
            self._oldest = (min(self._pending, key=lambda t: t.seq)
                            if self._pending else None)
        return wave

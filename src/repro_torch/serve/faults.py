"""Deterministic fault injection for the recon serving stack (a copy of
``repro.serve.faults``; the port imports nothing of the JAX package).

A :class:`FaultInjector` threaded through ``ReconEngine``/``WaveExecutor``
fires scripted faults at exact points in the wave lifecycle, so the
recovery machinery (bounded solo retry, the circuit breaker's degradation
from the fused int8 kernel B4 to the layered chain B5, the wave watchdog,
shed accounting) is tested against the same schedule every run instead of
hoping a flake reproduces.

Fault kinds (:data:`FAULT_KINDS`), each a :class:`FaultSpec`:

* ``dispatch_raise``   — the wave crashes before staging (engine level).
* ``kernel_fail``      — the forward raises on the wave's first tile
  (executor level): the trigger for the int8 circuit breaker.
* ``tile_timeout``     — the wave's completion wait raises
  :class:`WaveTimeout` (a stuck device / lost tile).
* ``slow_wave``        — the wave completes but reports ``delay_s`` of
  extra compute time: a straggling stall the adaptive controller and the
  watchdog must react to, with no real sleeping in tests.
* ``assembly_corrupt`` — assembling one request's maps raises (scatter of
  a corrupted prediction block).

Triggering is by engine wave index (``wave=``, fires **once** — a
transient infra blip) or by request id (``request_id=``, fires **every**
wave containing that request — a poisoned request that will never
succeed).  Transients deserve a retry, poison must fail alone after its
bounded retry, and wave-mates must survive both.

``injector.fired`` logs ``(wave_index, kind)`` tuples in firing order, so
tests and the chaos smoke can assert the schedule actually ran.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

FAULT_KINDS = ("dispatch_raise", "kernel_fail", "tile_timeout", "slow_wave",
               "assembly_corrupt")


class InjectedServeFault(RuntimeError):
    """An injected serving fault (never raised by real failures)."""


class WaveTimeout(InjectedServeFault):
    """A wave exceeded its completion budget (injected ``tile_timeout``)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault.

    ``wave`` triggers once at that engine dispatch index; ``request_id``
    triggers persistently for every wave containing that request.  Exactly
    one of the two must be set, except ``kernel_fail`` / ``tile_timeout`` /
    ``slow_wave`` which fire at points where no request identity is in
    scope and therefore require ``wave``.
    """

    kind: str
    wave: int | None = None
    request_id: str | None = None
    delay_s: float = 0.05  # slow_wave: synthetic stall added to compute time

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {FAULT_KINDS}")
        if (self.wave is None) == (self.request_id is None):
            raise ValueError(f"exactly one of wave / request_id must be set "
                             f"({self!r})")
        if self.kind in ("kernel_fail", "tile_timeout", "slow_wave") \
                and self.wave is None:
            raise ValueError(f"{self.kind} fires where no request identity "
                             f"is in scope; trigger it by wave= ({self!r})")


class FaultInjector:
    """Fires a deterministic fault schedule into the serving hot path.

    Accepts :class:`FaultSpec` instances or plain dicts (the launcher's
    ``--fault-schedule`` JSON).  Thread one injector through
    ``ReconEngine(injector=...)``; the engine hands it to its executor, so
    one schedule covers every injection point.
    """

    def __init__(self, schedule: Sequence):
        self._armed: list[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s)
            for s in schedule]
        self.fired: list[tuple[int, str]] = []

    def n_armed(self) -> int:
        """One-shot specs still waiting to fire (persistent request_id
        specs are never disarmed and always count)."""
        return len(self._armed)

    def _take(self, kinds: tuple, wave: int,
              request_ids: Iterable[str] | None = None) -> FaultSpec | None:
        rids = set(request_ids) if request_ids is not None else None
        for i, spec in enumerate(self._armed):
            if spec.kind not in kinds:
                continue
            if spec.request_id is not None:
                # persistent: a poisoned request re-fires on every retry
                if rids is not None and spec.request_id in rids:
                    self.fired.append((wave, spec.kind))
                    return spec
            elif spec.wave == wave:
                self._armed.pop(i)  # one-shot: a transient blip
                self.fired.append((wave, spec.kind))
                return spec
        return None

    # -- injection points (called by engine/executor) ----------------------

    def fire_dispatch(self, wave: int, request_ids: Iterable[str]) -> None:
        """Engine, before staging a wave: raises for ``dispatch_raise``."""
        spec = self._take(("dispatch_raise",), wave, request_ids)
        if spec is not None:
            what = (f"poisoned request {spec.request_id!r}"
                    if spec.request_id else "transient dispatch fault")
            raise InjectedServeFault(f"injected at wave {wave}: {what}")

    def fire_kernel(self, wave: int) -> None:
        """Executor, before the wave's first tile enqueue: raises for
        ``kernel_fail`` (what trips the int8 circuit breaker)."""
        if self._take(("kernel_fail",), wave) is not None:
            raise InjectedServeFault(
                f"injected kernel failure at wave {wave}")

    def fire_wait(self, wave: int) -> FaultSpec | None:
        """Engine, before blocking on a wave: raises :class:`WaveTimeout`
        for ``tile_timeout``; returns the spec for a (non-raising)
        ``slow_wave`` stall so the caller inflates its compute-time
        observation by ``delay_s``."""
        if self._take(("tile_timeout",), wave) is not None:
            raise WaveTimeout(f"injected tile timeout at wave {wave}")
        return self._take(("slow_wave",), wave)

    def fire_assemble(self, wave: int, request_id: str) -> None:
        """Engine, before scattering one request's maps: raises for
        ``assembly_corrupt`` (by wave — first request assembled in that
        wave — or by request id)."""
        if self._take(("assembly_corrupt",), wave,
                      (request_id,)) is not None:
            raise InjectedServeFault(
                f"injected assembly corruption for request {request_id!r} "
                f"at wave {wave}")

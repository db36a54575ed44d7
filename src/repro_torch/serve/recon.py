"""Pipelined MRF map-reconstruction serving engine (counterpart of
``repro.serve.recon``).

Serving is a three-layer stack; this module is the top:

* **Admission** (``serve.queue``) — a persistent :class:`RequestQueue` of
  lifecycle tickets (``pending -> scheduled -> done | failed | shed``)
  stamped with their enqueue time; waves form under ``max_wave_voxels`` /
  ``max_wait_ms`` / priority policy.
* **Execution** (``serve.executor``) — the double-buffered
  :class:`WaveExecutor`: pad-to-bucket tiling over a fixed shape set,
  device-side staging, asynchronous tile dispatch with one synchronization
  per wave, float or full-integer int8 backends (``int8_impl`` picks the
  fused CUDA kernel, the layered CUDA kernel chain or plain PyTorch — all
  bit-exact against ``qat.int_forward``).
* **Engine** (here) — :class:`ReconEngine` composes the two.
  ``mode="pipelined"`` keeps up to ``inflight_depth`` waves in flight, so
  staging of wave N+1 overlaps device compute of wave N; ``mode="sync"``
  retires each wave tile by tile before dispatching the next (the
  baseline).  Both run the identical forward, so their maps are
  bit-identical.  ``reconstruct(requests)`` validates everything, enqueues
  everything and drains.

Robustness layer
----------------
The engine is overload- and fault-hardened end to end:

* **Admission control** — pass ``admission=AdmissionPolicy(...)`` and the
  queue sheds (never queues-to-collapse) under load: bounded pending-voxel
  budget, deadline-aware rejection against the observed service rate (the
  engine feeds ``observe_service`` at every wave retire), priority
  displacement.  Shed tickets end in the distinct ``shed`` terminal state
  with a structured ``ShedReason``.
* **Bounded retry, solo blast radius** — a wave that crashes at dispatch
  or execution does not fail its wave-mates outright: tickets with retry
  budget left (``max_retries``, default 1) are requeued as *solo* waves
  (each retries alone, optionally after ``retry_backoff_s *
  2**(retries-1)`` of backoff), so only a request that keeps failing
  fails, and alone.
* **Degradation** — execution failures feed the executor's circuit
  breaker; once it trips, retried and later waves serve through the
  layered kernel chain B5 instead of the fused kernel B4, bit-exact
  (``engine.health()["degraded"]``).
* **Watchdog + adaptive pipelining** — each wave's staging and compute
  times are measured; ``wave_timeout_s`` flags stalls, and with
  ``adaptive=True`` an ``AdaptiveController`` (EWMA-driven, clamped)
  tunes ``inflight_depth`` and the wave voxel cap live.
* **Fault injection** — ``injector=FaultInjector(schedule)`` fires
  deterministic faults (``serve.faults``) at every lifecycle point.

Per-voxel predictions are denormalised on the device inside the executor's
forward and scattered back into map-shaped arrays through each request's
mask.  ``ReconOutput.latency_s`` measures enqueue-to-assembled time.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.serve.admission import AdaptiveController
from repro_torch.serve.executor import DEFAULT_BUCKETS, WaveExecutor
from repro_torch.serve.faults import WaveTimeout
from repro_torch.serve.queue import QueuedRequest, RequestQueue, RequestState

SERVE_MODES = ("sync", "pipelined")


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: tensor fields
class ReconRequest:
    """One slice/volume of fingerprints to reconstruct.

    ``features``: (n_voxels, 2F) float32 tensor (or array) — the masked
    voxels' [Re | Im] fingerprint features in row-major order.  ``mask``:
    optional bool array of any map shape with ``mask.sum() == n_voxels``;
    when given, results are scattered back into ``mask.shape`` maps
    (background voxels stay 0).  Without it, results stay flat.
    """

    features: torch.Tensor
    mask: np.ndarray | None = None
    request_id: str = ""

    @property
    def n_voxels(self) -> int:
        return int(self.features.shape[0])


@dataclasses.dataclass
class ReconOutput:
    request_id: str
    t1_ms: np.ndarray  # mask.shape maps, or (n_voxels,) when mask is None
    t2_ms: np.ndarray
    n_voxels: int
    latency_s: float   # enqueue-to-assembled (queue wait included)


def latency_percentiles(results: Sequence[ReconOutput]) -> dict:
    """p50/p90/p99 request latency (ms) over a batch of results; NaNs when
    empty."""
    if not results:
        return {f"p{p}_ms": float("nan") for p in (50, 90, 99)}
    lats = np.array([r.latency_s for r in results], np.float64) * 1e3
    return {f"p{p}_ms": float(np.percentile(lats, p)) for p in (50, 90, 99)}


class ReconEngine:
    """Queued, batched (T1, T2) map reconstruction on ``device``.

    ``backend="float"`` needs ``params``; ``backend="int8"`` needs
    ``int_layers``.  ``mode`` picks the executor discipline ("sync" =
    per-tile retirement; "pipelined" = up to ``inflight_depth`` waves in
    flight, one synchronization per wave); ``max_wave_voxels`` caps a wave,
    ``max_wait_ms`` is the admission deadline from enqueue.  ``int8_impl``
    selects the int8 implementation (``None`` = ``"fused"``).  The
    reference's Pallas-only ``interpret`` and ``int8_block_m`` have no
    counterpart: the CUDA kernels need no interpreter, and B4 picks its
    warps per tile from the tile's rows.  ``device`` defaults to
    ``"cuda"`` and raises without a card.

    Robustness knobs: ``admission`` installs a load-shedding policy
    (``serve.admission.AdmissionPolicy``); ``max_retries`` bounds the solo
    requeues a ticket gets after a failed wave (0: a failed wave fails its
    tickets); ``retry_backoff_s`` sleeps ``retry_backoff_s *
    2**(retries-1)`` before a retry wave dispatches (0 = immediate);
    ``wave_timeout_s`` flags waves whose completion wait exceeds it as
    stalls (health accounting + the adaptive controller's shrink signal);
    ``adaptive=True`` (or a configured ``AdaptiveController``) tunes
    ``inflight_depth`` and ``max_wave_voxels`` live — pipelined mode only;
    ``injector`` threads a deterministic ``serve.faults.FaultInjector``
    through every lifecycle point.
    """

    def __init__(self, *, backend: str = "float", params=None, int_layers=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, mode: str = "sync",
                 max_wave_voxels: int | None = None,
                 max_wait_ms: float | None = None, inflight_depth: int = 2,
                 int8_impl: str | None = None, admission=None, injector=None,
                 max_retries: int = 1, retry_backoff_s: float = 0.0,
                 wave_timeout_s: float | None = None, adaptive=False,
                 clock=time.perf_counter, device="cuda"):
        if mode not in SERVE_MODES:
            raise ValueError(f"mode {mode!r} not in {SERVE_MODES}")
        if inflight_depth < 1:
            raise ValueError(f"inflight_depth must be >= 1: {inflight_depth}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0: {max_retries}")
        if retry_backoff_s < 0:
            raise ValueError(f"retry_backoff_s must be >= 0: "
                             f"{retry_backoff_s}")
        if adaptive and mode != "pipelined":
            raise ValueError("adaptive pipelining tunes inflight_depth — "
                             "it requires mode='pipelined'")
        self.mode = mode
        self.executor = WaveExecutor(backend=backend, params=params,
                                     int_layers=int_layers, buckets=buckets,
                                     int8_impl=int8_impl, injector=injector,
                                     device=device)
        # one time source for enqueue and completion stamps
        self._clock = clock
        self.admission = admission
        self.queue = RequestQueue(max_wave_voxels=max_wave_voxels,
                                  max_wait_ms=max_wait_ms,
                                  validator=self._validate,
                                  admission=admission, clock=clock)
        self._injector = injector
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.wave_timeout_s = wave_timeout_s
        if isinstance(adaptive, AdaptiveController):
            self.controller = adaptive
        elif adaptive:
            self.controller = AdaptiveController(
                depth=inflight_depth,
                max_depth=max(AdaptiveController.max_depth, inflight_depth),
                wave_voxels=max_wave_voxels,
                max_wave_voxels=(max_wave_voxels * 4 if max_wave_voxels
                                 else AdaptiveController.max_wave_voxels))
        else:
            self.controller = None
        self._depth = 1 if mode == "sync" else int(inflight_depth)
        self._inflight: collections.deque = collections.deque()
        self._wave_seq = 0  # engine dispatch counter = fault-schedule index
        # stats of waves poll() retired (or that died at dispatch) since
        # the last drain — folded into the next drain's last_wave.  Stats
        # only, never tickets: the streaming caller holds those.
        self._early_stats = self._zero_stats()
        self._shed_mark = 0    # queue.n_shed watermark at the last drain
        self._t_epoch: float | None = None  # first dispatch since last drain
        self.last_wave: dict = {}
        # lifetime health counters (never reset by drain)
        self.n_retries_total = 0
        self.n_slow_waves = 0

    @staticmethod
    def _zero_stats() -> dict:
        return {"n_done": 0, "voxels": 0, "n_failed": 0, "n_waves": 0,
                "n_retries": 0}

    def _fold_early(self, wave: list) -> None:
        """Account a wave finalized outside drain() into the early stats.
        Requeued (pending-again) tickets are counted when their retry wave
        lands."""
        if not wave:
            return
        self._early_stats["n_waves"] += 1
        for t in wave:
            if t.state == RequestState.DONE:
                self._early_stats["n_done"] += 1
                self._early_stats["voxels"] += t.request.n_voxels
            elif t.state == RequestState.FAILED:
                self._early_stats["n_failed"] += 1

    # -- thin views over the layers (the executor owns the network state) --

    @property
    def backend(self) -> str:
        return self.executor.backend

    @property
    def params(self):
        return self.executor.params

    @property
    def int_layers(self):
        return self.executor.int_layers

    @property
    def buckets(self) -> tuple:
        return self.executor.buckets

    @property
    def in_dim(self) -> int:
        return self.executor.in_dim

    @property
    def int8_impl(self) -> str | None:
        return self.executor.int8_impl

    @property
    def request_sizes(self) -> list:
        """Voxel counts of every request dispatched, in order: the recorded
        size distribution that measured bucket autotuning reads."""
        return self.executor.request_sizes

    @property
    def bucket_shapes_run(self) -> set:
        return self.executor.bucket_shapes_run

    def compile_cache_size(self) -> int:
        """Distinct bucket shapes run so far (bounded by ``len(buckets)``)."""
        return self.executor.cache_size()

    # -- validation (admission-time, once per request) ---------------------

    def _validate(self, r: ReconRequest) -> str | None:
        if not hasattr(r.features, "shape"):
            return (f"request {r.request_id!r} features must be an array "
                    f"with .shape: got {type(r.features).__name__}")
        if len(r.features.shape) != 2:
            return (f"request {r.request_id!r} features must be rank-2 "
                    f"(n_voxels, features): got shape "
                    f"{tuple(r.features.shape)}")
        if int(r.features.shape[-1]) != self.in_dim:
            return (f"request {r.request_id!r} has feature dim "
                    f"{r.features.shape[-1]}, engine expects {self.in_dim}")
        # count the bool cast, exactly what _assemble scatters through
        if r.mask is not None and int(np.asarray(r.mask, bool).sum()) != r.n_voxels:
            return (f"request {r.request_id!r}: mask selects "
                    f"{int(np.asarray(r.mask, bool).sum())} voxels, features "
                    f"carry {r.n_voxels}")
        return None

    # -- streaming API -----------------------------------------------------

    def enqueue(self, request: ReconRequest, *, priority: int = 0,
                deadline_ms: float | None = None) -> QueuedRequest:
        """Admit one request; returns its lifecycle ticket.

        Invalid requests come back already ``failed`` (``ticket.error``
        set); admission never raises.  With an admission policy installed,
        a valid request can instead come back ``shed``
        (``ticket.shed_reason`` set): overloaded, retry later.
        ``deadline_ms`` is this request's wait budget for deadline-aware
        shedding (None: the policy default).
        """
        return self.queue.submit(request, priority=priority,
                                 deadline_ms=deadline_ms)

    def poll(self) -> int:
        """Dispatch every wave the formation policy says is due; blocks only
        for pipeline-full backpressure.  Returns waves dispatched."""
        n = 0
        while self.queue.n_pending and self.queue.wave_due():
            if len(self._inflight) >= self._depth:
                self._fold_early(self._retire_oldest())
            if self._dispatch(self.queue.form_wave()):
                n += 1
        return n

    def drain(self) -> list:
        """Serve everything: flush the queue through the executor, keeping
        up to ``inflight_depth`` waves in flight (pipelined) or exactly one
        retired tile by tile (sync).  Returns the results of waves retired
        by this call, in completion order; ``self.last_wave`` covers the
        whole session since the previous drain."""
        t0 = self._t_epoch if self._t_epoch is not None else self._clock()
        retired: list[QueuedRequest] = []
        n_waves = 0
        while self.queue.n_pending or self._inflight:
            while self.queue.n_pending and len(self._inflight) < self._depth:
                self._dispatch(self.queue.form_wave(flush=True))
            wave_tickets = self._retire_oldest()
            if wave_tickets:
                retired.extend(wave_tickets)
                n_waves += 1
        early = self._early_stats
        self._early_stats = self._zero_stats()
        wall = self._clock() - t0
        self._t_epoch = None
        n_shed = self.queue.n_shed - self._shed_mark
        self._shed_mark = self.queue.n_shed
        served = [t for t in retired if t.state == RequestState.DONE]
        total = sum(t.request.n_voxels for t in served) + early["voxels"]
        self.last_wave = {"n_requests": len(served) + early["n_done"],
                          "total_voxels": total, "wall_s": wall,
                          "voxels_per_s": total / max(wall, 1e-12),
                          "n_waves": n_waves + early["n_waves"],
                          "mode": self.mode,
                          "n_failed": (len(retired) - len(served)
                                       + early["n_failed"]),
                          "n_shed": n_shed,
                          "n_retries": early["n_retries"],
                          "degraded": self.executor.degraded}
        return [t.result for t in served]

    def health(self) -> dict:
        """Live robustness snapshot: degradation, failures, retries,
        shedding, stalls, and the current (possibly adaptive) knobs."""
        ex = self.executor
        return {"degraded": ex.degraded,
                "degraded_reason": ex.degraded_reason,
                "int8_impl": ex.int8_impl,
                "n_kernel_failures": ex.n_kernel_failures,
                "n_degraded_waves": ex.n_degraded_waves,
                "n_retries_total": self.n_retries_total,
                "n_slow_waves": self.n_slow_waves,
                "n_shed_total": self.queue.n_shed,
                "n_rejected_total": self.queue.n_rejected,
                "inflight_depth": self._depth,
                "max_wave_voxels": self.queue.max_wave_voxels,
                "service_rate_voxels_per_s": (
                    self.admission.service_rate
                    if self.admission is not None else None)}

    def reconstruct(self, requests: Sequence[ReconRequest]) -> list:
        """Serve one batch: validate all, enqueue all, drain.

        All-or-nothing admission: a bad request raises here before any is
        admitted.  Returns one :class:`ReconOutput` per request, in request
        order; if serving any request failed or was shed, the wave still
        completes for everyone else and *then* this raises.
        """
        if not requests:
            self.last_wave = {"n_requests": 0, "total_voxels": 0,
                              "wall_s": 0.0, "voxels_per_s": 0.0,
                              "n_waves": 0, "mode": self.mode, "n_failed": 0}
            return []
        for r in requests:
            err = self._validate(r)
            if err is not None:
                raise ValueError(err)
        tickets = [self.queue.submit(r, validate=False) for r in requests]
        self.drain()
        failed = [t for t in tickets if t.state in (RequestState.FAILED,
                                                    RequestState.SHED)]
        if failed:
            raise ValueError(
                f"{len(failed)} request(s) failed while serving the wave: "
                + "; ".join(t.error for t in failed[:3]))
        return [t.result for t in tickets]

    # -- wave mechanics ----------------------------------------------------

    def _wave_failed(self, wave: list, stage: str, exc: Exception) -> int:
        """Bounded-retry failure policy for a crashed wave; returns how many
        tickets it marked failed.  Still-scheduled tickets with retry budget
        left go back to the queue as *solo* tickets; the rest fail.  With
        ``retry_backoff_s`` the engine sleeps before the retry waves can
        dispatch, doubling per retry already taken."""
        retried = failed = 0
        for t in wave:
            if t.state != RequestState.SCHEDULED:
                continue  # sync mode may have assembled some already
            if t.retries < self.max_retries:
                t.retries += 1
                t.solo = True
                self.queue.requeue(t)
                retried += 1
            else:
                t.state = RequestState.FAILED
                t.error = (f"wave {stage} failed"
                           f"{' after retry' if t.retries else ''}: "
                           f"{type(exc).__name__}: {exc}")
                failed += 1
        if retried:
            self._early_stats["n_retries"] += retried
            self.n_retries_total += retried
            if self.retry_backoff_s > 0:
                worst = max(t.retries for t in wave
                            if t.state == RequestState.PENDING)
                time.sleep(self.retry_backoff_s * 2 ** (worst - 1))
        return failed

    def _dispatch(self, wave: list) -> bool:
        """Stage + enqueue one wave; True iff it actually entered flight."""
        if not wave:
            return False
        widx = self._wave_seq
        self._wave_seq += 1
        t_start = self._clock()
        try:
            if self._injector is not None:
                self._injector.fire_dispatch(
                    widx, [t.request.request_id for t in wave])
            handle = self.executor.dispatch(
                [t.request.features for t in wave], wave_index=widx)
        except Exception as e:  # a lifecycle state, not a raise
            # a wave that cannot stage requeues/fails its tickets instead of
            # raising out of poll()/drain() and stranding them "scheduled";
            # it never entered flight, so its failures count here
            self._early_stats["n_failed"] += self._wave_failed(
                wave, "dispatch", e)
            return False
        if self._t_epoch is None:
            # the session clock starts at the first wave that entered flight
            self._t_epoch = t_start
        staging_s = self._clock() - t_start
        self._inflight.append((wave, handle, widx, staging_s))
        return True

    def _retire_oldest(self) -> list:
        """Complete the oldest in-flight wave and assemble its requests;
        returns the wave's *finalized* tickets (requeued ones excluded).

        Sync mode syncs tile by tile so each request is assembled the moment
        its last tile lands; pipelined mode synchronizes once for the whole
        wave (``InflightWave.wait``).  The wait is watchdogged
        (``wave_timeout_s``) and its measured staging/compute split feeds
        the admission service-rate estimate and the adaptive controller.
        """
        if not self._inflight:
            return []
        wave, handle, widx, staging_s = self._inflight.popleft()
        counts = [t.request.n_voxels for t in wave]
        ends = np.cumsum(counts) if counts else np.zeros(0, np.int64)
        pred_ms = None
        done = 0

        def assemble_upto(covered):
            nonlocal done
            now = self._clock()
            while done < len(wave) and ends[done] <= covered:
                end = int(ends[done])
                self._finish(wave[done], pred_ms[end - counts[done]:end],
                             now, widx)
                done += 1

        t_wait = self._clock()
        stall_s = 0.0
        try:
            if self._injector is not None:
                spec = self._injector.fire_wait(widx)  # raises WaveTimeout
                if spec is not None:  # slow_wave: a synthetic stall
                    stall_s = spec.delay_s
            if self.mode == "sync":
                pred_ms = np.empty((handle.total, 2), np.float32)
                covered = 0
                for off, count, block in handle.wait_tiles():
                    pred_ms[off:off + count] = block
                    covered += count
                    assemble_upto(covered)
            else:
                pred_ms = handle.wait()
            assemble_upto(handle.total)  # remainder incl. zero-voxel requests
        except Exception as e:  # a lifecycle state, not a raise
            # the wave was already popped, so strand nothing "scheduled":
            # retry-budgeted tickets requeue solo, the rest fail
            if not isinstance(e, WaveTimeout):
                # a kernel's failure can surface at the event sync; feed
                # the circuit breaker so retries (and later waves) serve
                # degraded
                self.executor.note_kernel_failure()
            self._wave_failed(wave, "execution", e)
            return [t for t in wave
                    if t.state in (RequestState.DONE, RequestState.FAILED)]
        compute_s = self._clock() - t_wait + stall_s
        stalled = stall_s > 0 or (self.wave_timeout_s is not None
                                  and compute_s > self.wave_timeout_s)
        if stalled:
            self.n_slow_waves += 1
        if self.admission is not None:
            self.admission.observe_service(handle.total, compute_s)
        if self.controller is not None:
            depth, cap = self.controller.observe(
                staging_s=staging_s, compute_s=compute_s,
                n_voxels=handle.total, stalled=stalled)
            self._depth = depth
            if cap is not None:
                self.queue.max_wave_voxels = cap
        return wave

    def _finish(self, ticket: QueuedRequest, pred_ms_slice: np.ndarray,
                now: float, wave_index: int = -1) -> None:
        try:
            if self._injector is not None:
                self._injector.fire_assemble(wave_index,
                                             ticket.request.request_id)
            ticket.result = self._assemble(ticket.request, pred_ms_slice,
                                           now - ticket.enqueue_t)
        except Exception as e:  # surfaced as a lifecycle state
            ticket.state = RequestState.FAILED
            ticket.error = f"{type(e).__name__}: {e}"
            return
        ticket.state = RequestState.DONE
        ticket.done_t = now

    def _assemble(self, req: ReconRequest, pred_ms: np.ndarray,
                  latency_s: float) -> ReconOutput:
        """Scatter one request's already-denormalized (ms) predictions."""
        if req.mask is not None:
            mask = np.asarray(req.mask, bool)
            t1 = np.zeros(mask.shape, np.float32)
            t2 = np.zeros(mask.shape, np.float32)
            t1[mask] = pred_ms[:, 0]
            t2[mask] = pred_ms[:, 1]
        else:
            t1, t2 = pred_ms[:, 0].copy(), pred_ms[:, 1].copy()
        return ReconOutput(request_id=req.request_id, t1_ms=t1, t2_ms=t2,
                           n_voxels=int(pred_ms.shape[0]),
                           latency_s=latency_s)

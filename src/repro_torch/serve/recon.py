"""Pipelined MRF map-reconstruction serving engine (counterpart of
``repro.serve.recon``).

Serving is a three-layer stack; this module is the top:

* **Admission** (``serve.queue``) — a persistent :class:`RequestQueue` of
  lifecycle tickets (``pending -> scheduled -> done | failed``) stamped
  with their enqueue time; waves form under ``max_wave_voxels`` /
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

A wave that crashes at dispatch or execution does not fail its wave-mates
outright: tickets with retry budget left (``max_retries``, default 1) are
requeued as *solo* waves, so only a request that keeps failing fails, and
alone.  Load shedding, fault injection, the watchdog and adaptive
pipelining arrive with the serving robustness slice.

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

from repro_torch.serve.executor import DEFAULT_BUCKETS, WaveExecutor
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
    selects the int8 implementation (``None`` = ``"fused"``).
    ``max_retries`` bounds the solo requeues a ticket gets after a failed
    wave (0: a failed wave fails its tickets).  ``device`` defaults to
    ``"cuda"`` and raises without a card.
    """

    def __init__(self, *, backend: str = "float", params=None, int_layers=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, mode: str = "sync",
                 max_wave_voxels: int | None = None,
                 max_wait_ms: float | None = None, inflight_depth: int = 2,
                 int8_impl: str | None = None, max_retries: int = 1,
                 clock=time.perf_counter, device="cuda"):
        if mode not in SERVE_MODES:
            raise ValueError(f"mode {mode!r} not in {SERVE_MODES}")
        if inflight_depth < 1:
            raise ValueError(f"inflight_depth must be >= 1: {inflight_depth}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0: {max_retries}")
        self.mode = mode
        self.executor = WaveExecutor(backend=backend, params=params,
                                     int_layers=int_layers, buckets=buckets,
                                     int8_impl=int8_impl, device=device)
        # one time source for enqueue and completion stamps
        self._clock = clock
        self.queue = RequestQueue(max_wave_voxels=max_wave_voxels,
                                  max_wait_ms=max_wait_ms,
                                  validator=self._validate, clock=clock)
        self.max_retries = int(max_retries)
        self._depth = 1 if mode == "sync" else int(inflight_depth)
        self._inflight: collections.deque = collections.deque()
        # stats of waves poll() retired (or that died at dispatch) since
        # the last drain — folded into the next drain's last_wave.  Stats
        # only, never tickets: the streaming caller holds those.
        self._early_stats = self._zero_stats()
        self._t_epoch: float | None = None  # first dispatch since last drain
        self.last_wave: dict = {}
        self.n_retries_total = 0

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
    def buckets(self) -> tuple:
        return self.executor.buckets

    @property
    def in_dim(self) -> int:
        return self.executor.in_dim

    @property
    def int8_impl(self) -> str | None:
        return self.executor.int8_impl

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

    def enqueue(self, request: ReconRequest, *,
                priority: int = 0) -> QueuedRequest:
        """Admit one request; returns its lifecycle ticket.  Invalid
        requests come back already ``failed`` (``ticket.error`` set);
        admission never raises."""
        return self.queue.submit(request, priority=priority)

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
        served = [t for t in retired if t.state == RequestState.DONE]
        total = sum(t.request.n_voxels for t in served) + early["voxels"]
        self.last_wave = {"n_requests": len(served) + early["n_done"],
                          "total_voxels": total, "wall_s": wall,
                          "voxels_per_s": total / max(wall, 1e-12),
                          "n_waves": n_waves + early["n_waves"],
                          "mode": self.mode,
                          "n_failed": (len(retired) - len(served)
                                       + early["n_failed"]),
                          "n_retries": early["n_retries"]}
        return [t.result for t in served]

    def reconstruct(self, requests: Sequence[ReconRequest]) -> list:
        """Serve one batch: validate all, enqueue all, drain.

        All-or-nothing admission: a bad request raises here before any is
        admitted.  Returns one :class:`ReconOutput` per request, in request
        order; if serving any request failed, the wave still completes for
        everyone else and *then* this raises.
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
        failed = [t for t in tickets if t.state == RequestState.FAILED]
        if failed:
            raise ValueError(
                f"{len(failed)} request(s) failed while serving the wave: "
                + "; ".join(t.error for t in failed[:3]))
        return [t.result for t in tickets]

    # -- wave mechanics ----------------------------------------------------

    def _wave_failed(self, wave: list, stage: str, exc: Exception) -> int:
        """Bounded-retry failure policy for a crashed wave; returns how many
        tickets it marked failed.  Still-scheduled tickets with retry budget
        left go back to the queue as *solo* tickets; the rest fail."""
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
        return failed

    def _dispatch(self, wave: list) -> bool:
        """Stage + enqueue one wave; True iff it actually entered flight."""
        if not wave:
            return False
        t_start = self._clock()
        try:
            handle = self.executor.dispatch([t.request.features for t in wave])
        except Exception as e:  # a lifecycle state, not a raise
            # a wave that cannot stage requeues/fails its tickets instead of
            # raising out of poll()/drain() and stranding them "scheduled"
            self._early_stats["n_failed"] += self._wave_failed(
                wave, "dispatch", e)
            return False
        if self._t_epoch is None:
            self._t_epoch = t_start
        self._inflight.append((wave, handle))
        return True

    def _retire_oldest(self) -> list:
        """Complete the oldest in-flight wave and assemble its requests;
        returns the wave's *finalized* tickets (requeued ones excluded).

        Sync mode syncs tile by tile so each request is assembled the moment
        its last tile lands; pipelined mode synchronizes once for the whole
        wave (``InflightWave.wait``).
        """
        if not self._inflight:
            return []
        wave, handle = self._inflight.popleft()
        counts = [t.request.n_voxels for t in wave]
        ends = np.cumsum(counts) if counts else np.zeros(0, np.int64)
        pred_ms = None
        done = 0

        def assemble_upto(covered):
            nonlocal done
            now = self._clock()
            while done < len(wave) and ends[done] <= covered:
                end = int(ends[done])
                self._finish(wave[done], pred_ms[end - counts[done]:end], now)
                done += 1

        try:
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
            self._wave_failed(wave, "execution", e)
            return [t for t in wave
                    if t.state in (RequestState.DONE, RequestState.FAILED)]
        return wave

    def _finish(self, ticket: QueuedRequest, pred_ms_slice: np.ndarray,
                now: float) -> None:
        try:
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

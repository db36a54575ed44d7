"""Fault-tolerant training loop: periodic asynchronous checkpoints, resume
from the latest, the straggler watchdog and restart after a crash
(counterpart of ``repro.ft.runner``).

Dispatch modes
--------------
Stepwise (``chunk_steps=1``): one ``train_step(state, batches(step))`` call
per step.  The loop waits for each step's loss only when an ``on_metrics``
callback is registered (its ``dt`` is then the step's true wall time);
without one, steps queue on the device and the host waits only at
checkpoints and at the end — the straggler monitor then sees the host's
dispatch time.

Chunked (``chunk_steps > 1`` and a ``chunk_fn``): ``chunk_fn(state, start,
n)`` runs ``n`` steps (``train.engine.build_chunk_fn``) and returns each
metric stacked ``(n,)``.  The loop dispatches chunk N+1 *before* it fetches
chunk N's metrics — one host fetch per chunk — so the device does not idle
on the fetch.  Chunk ends are clipped to checkpoint boundaries, to
``total_steps`` and to the fault-injection step, so checkpoints land where
the stepwise loop puts them and a resume starts from a chunk boundary.
The straggler monitor gets each chunk's wall time over its length.

Fault injection (``inject_fault_at``) makes the loop "crash" at a chosen
step (``SimulatedCrash``, the JAX package's ``InjectedFault``); the restart
resumes from the latest checkpoint and must reach the same final state as a
run without the crash.

``ckpt_every <= 0`` (the port's own setting; the reference always
checkpoints) writes no checkpoint at all, not even step 0's, and resumes
from none: a crash restarts from the initial state.  A benchmark run of a
model whose state is tens of GB skips the writes so.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import obs
from repro_torch.dist.sharding import layout_of
from repro_torch.ft.checkpoint import CheckpointManager, latest_step, save_state
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.kernels.common import resolve_device
from repro_torch.tree import leaves, tree_map


class SimulatedCrash(RuntimeError):
    """The crash ``RunnerConfig.inject_fault_at`` stages."""


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50      # <= 0: no checkpoints (module docstring)
    keep: int = 3
    max_restarts: int = 3
    inject_fault_at: int | None = None


def _next_boundary(step: int, every: int) -> int:
    return (step // every + 1) * every


class _NoCheckpoints:
    """The manager of a run without checkpoints: saves nothing, resumes
    from nothing."""

    def maybe_save(self, state, step: int, *, force: bool = False) -> bool:
        return False

    def wait(self) -> None:
        pass

    def restore_latest(self, like, *, device="cuda", placements=None):
        return None, 0


def _wait_device(tensors) -> None:
    """Block until the device has computed ``tensors`` (a no-op on CPU)."""
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)  # torchlint: disable=HOSTSYNC -- the runner's one wait: each step only where a caller asks for per-step metrics, and once at a loop's exit


def run(train_step: Callable | None, init_state, batches: Callable[[int], Any],
        cfg: RunnerConfig, *, device="cuda", shardings=None, on_metrics=None,
        chunk_fn: Callable | None = None, chunk_steps: int = 1):
    """Run to ``cfg.total_steps`` with checkpoint and restart.

    Returns ``(state, step)``.  ``batches`` is a *seekable* factory:
    ``batches(step)`` gives the same batch for the same step on every call,
    so a restart replays the stream from the resume step.  With
    ``chunk_steps > 1`` a ``chunk_fn(state, start, n)`` is required and
    ``batches`` is not consulted.  ``device``: where a restored state goes;
    ``shardings``: a tree of ``dist.sharding.Layout`` (or ``None``) placing
    its leaves onto a mesh, by default the initial state's own layouts (a
    sharded state restores sharded, onto the mesh it trains on).

    ``init_state`` is the initial state, or a function of no arguments that
    makes it.  Given the function, nothing keeps the initial state alive
    once the first step has replaced it (or a checkpoint stands in for it),
    so the device holds one state, not two (12 bytes a parameter of Adam's
    state at full width); a restart with no checkpoint to resume from makes
    it anew (a seeded init repeats its bits).
    """
    if chunk_steps > 1 and chunk_fn is None:
        raise ValueError("chunk_steps > 1 requires a chunk_fn "
                         "(see train/engine.build_chunk_fn)")
    dev = resolve_device(device)
    make = init_state if callable(init_state) else (lambda: init_state)
    # the state a loop starts from travels in a one-element list that the
    # loop empties: no other name holds it while the loop runs
    box = [make()]
    like = tree_map(lambda t: torch.empty((), device="meta"), box[0])
    if shardings is None:
        shardings = tree_map(layout_of, box[0])
    monitor = StragglerMonitor()
    restarts = 0
    faults_remaining = 1 if cfg.inject_fault_at is not None else 0
    if cfg.ckpt_every > 0:
        mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                every=cfg.ckpt_every)
        # step-0 checkpoint: a crash before the first periodic checkpoint
        # restarts from here
        if latest_step(cfg.ckpt_dir) is None:
            save_state(box[0], cfg.ckpt_dir, 0, async_io=False)  # torchlint: disable=HOSTSYNC -- the step-0 checkpoint is written before the loop starts; its host copy is the point
    else:  # no boundary is ever reached
        mgr = _NoCheckpoints()
        cfg = dataclasses.replace(cfg, ckpt_every=cfg.total_steps + 1)

    while True:
        restored, start = mgr.restore_latest(like, device=dev,
                                             placements=shardings)
        if restored is not None:
            box = [restored]
        elif not box:  # a restart with no checkpoint
            box = [make()]
        del restored
        try:
            if chunk_steps > 1:
                state, step = _chunked_loop(
                    chunk_fn, box, start, cfg, mgr, monitor,
                    on_metrics=on_metrics, chunk_steps=chunk_steps,
                    fault_live=faults_remaining > 0)
            else:
                state, step = _stepwise_loop(
                    train_step, box, start, batches, cfg, mgr, monitor,
                    on_metrics=on_metrics, fault_live=faults_remaining > 0)
            if step is None:  # the staged fault fired inside the loop
                faults_remaining -= 1
                raise SimulatedCrash(f"injected at step {cfg.inject_fault_at}")
            mgr.wait()
            return state, step
        except SimulatedCrash:
            restarts += 1
            if restarts > cfg.max_restarts:
                raise
            state = None  # the crashed state goes before the restart's
            mgr.wait()  # flush any pending save, then "restart"


def _stepwise_loop(train_step, box, step, batches, cfg, mgr, monitor, *,
                   on_metrics, fault_live):
    """One step per call from the state ``box`` holds (taken out of it).
    Returns (state, step), or (state, None) when the staged fault fires
    (the caller raises)."""
    state = box.pop()
    while step < cfg.total_steps:
        batch = batches(step)
        t0 = time.perf_counter()
        if fault_live and step == cfg.inject_fault_at:
            return state, None
        with obs.span("repro_torch.runner.dispatch"):
            state, metrics = train_step(state, batch)
        obs.count("steps")
        if on_metrics is not None:  # per-step wall time, not dispatch time
            with obs.span("repro_torch.runner.retire", wait=True):
                _wait_device([metrics["loss"]])
        dt = time.perf_counter() - t0
        if monitor.update(dt) == "checkpoint_and_evict":
            mgr.maybe_save(state, step + 1, force=True)  # snapshot pre-evict
        step += 1
        mgr.maybe_save(state, step)
        if on_metrics is not None:
            on_metrics(step, metrics, dt)
    _wait_device(leaves(state))
    return state, step


def _chunked_loop(chunk_fn, box, step, cfg, mgr, monitor, *, on_metrics,
                  chunk_steps, fault_live):
    """Whole chunks per call from the state ``box`` holds (taken out of it),
    metrics retired one chunk behind.  Returns (state, step), or (state,
    None) when the staged fault fires."""
    state = box.pop()
    inflight = None  # (chunk start step, n, stacked metrics, dispatch t0)
    retired_at = float("-inf")  # when the device last went idle (host clock)

    def retire(chunk):
        """Fetch a chunk's stacked metrics (one host copy), fan them out."""
        nonlocal retired_at
        c_start, n, metrics, t0 = chunk
        keys = sorted(metrics)
        with obs.span("repro_torch.runner.retire", wait=True):
            host = torch.stack([metrics[k] for k in keys]).cpu()
        now = time.perf_counter()
        # a chunk dispatched while its predecessor still ran started only
        # when that one retired: do not count the overlap twice
        dt = now - max(t0, retired_at)
        retired_at = now
        action = monitor.update(dt / n)
        if on_metrics is not None:
            for i in range(n):
                on_metrics(c_start + i + 1,
                           {k: host[j, i] for j, k in enumerate(keys)}, dt / n)
        return action

    while step < cfg.total_steps:
        if fault_live and step == cfg.inject_fault_at:
            if inflight is not None:  # deliver the completed steps' metrics
                retire(inflight)
            return state, None
        n = min(chunk_steps, cfg.total_steps - step,
                _next_boundary(step, cfg.ckpt_every) - step)
        if fault_live and step < cfg.inject_fault_at:
            n = min(n, cfg.inject_fault_at - step)
        t0 = time.perf_counter()
        with obs.span("repro_torch.runner.dispatch"):
            state, metrics = chunk_fn(state, step, n)
        obs.count("steps", n)
        obs.count("chunks")
        prev, inflight = inflight, (step, n, metrics, t0)
        step += n
        if prev is not None:  # chunk N computes while N-1 retires
            if retire(prev) == "checkpoint_and_evict":
                mgr.maybe_save(state, step, force=True)  # snapshot pre-evict
        if step % cfg.ckpt_every == 0 and step < cfg.total_steps:
            with obs.span("repro_torch.runner.checkpoint"):  # the drain
                retire(inflight)
            inflight = None
            mgr.maybe_save(state, step)
    if inflight is not None:
        retire(inflight)
    _wait_device(leaves(state))
    mgr.maybe_save(state, step)
    return state, step

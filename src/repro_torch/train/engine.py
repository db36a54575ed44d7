"""One training engine for the MRF nets, stepwise or chunked (counterpart
of ``repro.train.engine``).

Every backend gives the same ``(TrainState, batch) -> (TrainState,
metrics)`` step and runs under ``ft.runner``, with checkpoint and restart,
the straggler watchdog and a seekable data stream.

Backends
--------
``float``     autograd on the fp32 MSE loss -> Adam/SGD (the paper's
              software setup).
``qat-int8``  fake-quant forward with EMA activation observers, which ride
              in ``TrainState.aux`` and so checkpoint with the params.
``fused``     the whole-step CUDA kernel (``kernels/fused_train``, the JAX
              package's ``fused-pallas``): forward, backprop and the SGD or
              Adam update in one launch.

Chunked execution
-----------------
``chunk_steps > 1`` runs ``n`` steps per call of ``chunk_fn(state, start,
n)``.  For ``float`` and ``qat-int8`` a chunk is a loop of the stepwise
step over ``batch_at(stream, seed, start + k)``, the batches the stepwise
factory draws.  For ``fused`` a chunk stages those ``n`` batches into one
stream and makes **one** multi-step kernel launch, the net (and Adam's
moments) resident across all ``n`` steps.  Chunked is bit-identical to
stepwise for every backend — same final state, same per-step losses.

Under a mesh (``train(..., rules=)``, ``launch/train.py --mesh``)
-------------------------------------------------------------
The params and the optimizer state are DTensors placed by
``fns.param_axes()`` (the MRF nets': all ``None``, replicated).  ``float``
and ``qat-int8`` run data-parallel: each batch's features and targets are
placed on ``"batch"``, each data rank keeping its own rows of the step's
global batch, and the gradients are reduced onto the replicated params
(``train.step``).  ``fused`` does what the reference does with its
``pallas_call`` under a mesh: the kernel has no sharding rule and runs on
the whole batch, unsharded (``tests/test_torch_dist_sharding.py::
test_reference_runs_its_fused_kernel_unsharded_under_a_mesh`` checks the
reference in a 4-device subprocess).  Here every rank draws the whole
global batch (replicated) and launches B1-B3 on its local copies of the
replicated params (:func:`replicated_local`): the kernel never sees a
DTensor, and every rank computes the same update.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from torch.distributed.tensor import DTensor, Replicate

from repro_torch import obs
from repro_torch.data.epg import default_sequence
from repro_torch.data.pipeline import (MRFSampleStream, batch_at,
                                       make_batch_factory)
from repro_torch.dist.sharding import (AxisRules, distribute_tree,
                                       replicated_like)
from repro_torch.ft.checkpoint import latest_step
from repro_torch.ft.runner import RunnerConfig, run
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.fused_train import ops as fused_ops
from repro_torch.models.lm import ModelFns
from repro_torch.optim import adam, sgd
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_chunked_step, make_train_step)
from repro_torch.tree import leaves, tree_map

BACKENDS = ("float", "qat-int8", "fused")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    backend: str = "float"
    lr: float = 1e-4
    optimizer: str = "adam"       # paper: Adam in software, SGD on the FPGA
    microbatches: int = 1
    max_grad_norm: float | None = None  # None = no clipping (paper setup)
    grad_compress: bool = False
    # fused only: tile_batch=1 is the paper's per-sample SGD stream; larger
    # tiles are one minibatch update per tile (a ceiling: see effective_tile)
    tile_batch: int = 128
    chunk_steps: int = 1          # 1 = stepwise; > 1 = n steps per call

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.chunk_steps < 1:
            raise ValueError(f"chunk_steps={self.chunk_steps} must be >= 1")
        if self.optimizer not in ("adam", "sgd"):
            raise ValueError(f"optimizer must be one of ('adam', 'sgd'), got "
                             f"{self.optimizer!r}")
        if self.backend == "fused":
            # the kernel computes grads AND the update: there is no grad
            # tree to accumulate or compress, so refuse rather than train
            # something else
            if self.microbatches != 1:
                raise ValueError(
                    f"fused computes the update in-kernel: "
                    f"microbatches={self.microbatches} cannot be honored")
            if self.grad_compress:
                raise ValueError("fused computes the update in-kernel: "
                                 "grad_compress cannot be honored")
            if self.optimizer not in fused_ops.FUSED_OPTIMIZERS:
                raise ValueError(
                    f"fused implements optimizers "
                    f"{fused_ops.FUSED_OPTIMIZERS} in-kernel, got "
                    f"{self.optimizer!r}")


def replicated_local(fn):
    """``fn`` over trees whose DTensor leaves are all replicated: each rank
    calls ``fn`` on its local (whole) copies, and every tensor ``fn``
    returns is stated replicated on the same mesh.  Plain inputs pass
    as they are; without a DTensor input ``fn`` runs unchanged."""
    def wrapped(*args, **kwargs):
        dts = [t for t in leaves(list(args)) if isinstance(t, DTensor)]
        if not dts:
            return fn(*args, **kwargs)
        mesh = dts[0].device_mesh
        for t in dts:
            if t.device_mesh != mesh or not all(
                    isinstance(p, Replicate) for p in t.placements):
                raise ValueError(f"replicated_local: an input placed "
                                 f"{tuple(t.placements)}; the kernel runs "
                                 f"on replicated inputs only")
        local = tree_map(lambda t: t.to_local() if isinstance(t, DTensor)
                         else t, list(args))
        return tree_map(lambda t: DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False),
            fn(*local, **kwargs))
    return wrapped


def _optimizer(cfg: EngineConfig):
    return adam(cfg.lr) if cfg.optimizer == "adam" else sgd(cfg.lr)


def _backend_step(fns: ModelFns, cfg: EngineConfig, opt):
    """(``(state, batch) -> (state, metrics)`` step, aux factory) for
    ``cfg.backend``: the shared core of ``build`` and ``build_chunk_fn``."""
    if cfg.backend == "fused":
        # the rule lives in the kernel; ``opt`` still shapes the optimizer
        # state (Adam's moments), which the kernel reads and writes
        step = make_train_step(
            None, opt, fused_step=replicated_local(fused_ops.make_engine_step(
                lr=cfg.lr, optimizer=cfg.optimizer,
                tile_batch=cfg.tile_batch)))
        return step, lambda params: None
    if cfg.backend == "qat-int8":
        step = make_train_step(
            fns.qat_loss, opt, microbatches=cfg.microbatches,
            max_grad_norm=cfg.max_grad_norm, grad_compress=cfg.grad_compress,
            aux_loss=True)
        return step, fns.init_qat_aux
    step = make_train_step(
        fns.loss, opt, microbatches=cfg.microbatches,
        max_grad_norm=cfg.max_grad_norm, grad_compress=cfg.grad_compress)
    return step, lambda params: None


def _make_init(fns: ModelFns, cfg: EngineConfig, opt, aux_of,
               rules: AxisRules | None = None):
    def init_state(generator: torch.Generator) -> TrainState:
        params = fns.init(generator)
        if rules is not None:
            params = distribute_tree(params, fns.param_axes(), rules)
        aux = tree_map(lambda t: replicated_like(t, leaves(params)[0]),
                       aux_of(params))
        return init_train_state(params, opt, grad_compress=cfg.grad_compress,
                                aux=aux)
    return init_state


def batch_placer(cfg: EngineConfig, rules: AxisRules | None):
    """``batch -> batch`` placed under ``rules`` (the identity without):
    the features' and targets' rows on ``"batch"``, each data rank keeping
    its own rows of the step's global batch; replicated for ``fused``."""
    if rules is None:
        return lambda batch: batch
    rows = (None, None) if cfg.backend == "fused" else ("batch", None)
    return lambda batch: distribute_tree(batch, {"x": rows, "y": rows}, rules)


def _placed(batches, place):
    return lambda step: place(batches(step))


def build(fns: ModelFns, cfg: EngineConfig, rules: AxisRules | None = None
          ) -> tuple[Callable, Callable[[torch.Generator], TrainState]]:
    """(step ``(state, batch) -> (state, metrics)``,
    ``init_state(generator) -> TrainState``) for any backend; the state
    lives on the generator's device, placed under ``rules`` when given
    (module docstring)."""
    opt = _optimizer(cfg)
    step, aux_of = _backend_step(fns, cfg, opt)
    return step, _make_init(fns, cfg, opt, aux_of, rules)


def _make_fused_chunk(cfg: EngineConfig, stream: MRFSampleStream, seed: int,
                      device):
    """``chunk_fn(state, start, n)`` for the fused backend: the ``n``
    batches ``batch_at(stream, seed, start + k)`` staged back to back, then
    **one** multi-step kernel launch over all of them."""
    def chunk_step(state: TrainState, start: int, n: int):
        with obs.span("repro_torch.data.stage"):
            staged = [batch_at(stream, seed, start + k, device=device)
                      for k in range(n)]
            x = torch.cat([b["x"] for b in staged])
            y = torch.cat([b["y"] for b in staged])
        with obs.span("repro_torch.kernel.launch"):
            new_params, new_opt, losses = replicated_local(
                fused_ops.fused_train_multistep)(
                state.params, state.opt_state, x, y, n_steps=n, lr=cfg.lr,
                optimizer=cfg.optimizer, tile_batch=cfg.tile_batch)
        return TrainState(step=state.step + n, params=new_params,
                          opt_state=new_opt, ef_residual=state.ef_residual,
                          aux=state.aux), {
                              "loss": fused_ops.step_losses(losses)}
    return chunk_step


def build_chunk_fn(fns: ModelFns, cfg: EngineConfig, stream: MRFSampleStream,
                   seed: int, *, device="cuda", rules: AxisRules | None = None
                   ) -> tuple[Callable, Callable[[torch.Generator], TrainState]]:
    """(``chunk_fn(state, start, n) -> (state, stacked metrics)``,
    ``init_state``): the chunked dispatcher of any backend (the JAX
    package's ``build_chunked``).  Chunk ``[start, start + n)`` draws the
    batches the stepwise factory would."""
    dev = resolve_device(device)
    opt = _optimizer(cfg)
    step, aux_of = _backend_step(fns, cfg, opt)
    if cfg.backend == "fused":
        chunk = _make_fused_chunk(cfg, stream, seed, dev)
    else:
        place = batch_placer(cfg, rules)
        chunk = make_chunked_step(
            step, lambda s: place(batch_at(stream, seed, s, device=dev)))
    return chunk, _make_init(fns, cfg, opt, aux_of, rules)


def default_stream(model_cfg, batch_size: int) -> MRFSampleStream:
    return MRFSampleStream(seq=default_sequence(model_cfg.mrf_n_frames),
                           batch_size=batch_size)


def train(fns: ModelFns, engine_cfg: EngineConfig, runner_cfg: RunnerConfig,
          *, batches: Callable[[int], Any] | None = None,
          stream: MRFSampleStream | None = None, seed: int = 1,
          init_seed: int = 0, batch_size: int = 256, on_metrics=None,
          device="cuda", rules: AxisRules | None = None):
    """Train an MRF net end to end through ``ft.runner`` on ``device``.

    Returns ``(state, step, info)``; ``info`` carries the wall-clock
    seconds and samples/s.  ``batches`` (a seekable ``step -> batch``
    factory) replaces the default ``batch_at(stream, seed, .)`` stream in
    stepwise mode only: chunked runs stage their own batches from the
    ``stream``/``seed`` pair.  The net is initialised from a generator
    seeded with ``init_seed``.  ``rules`` (mesh-bound): the run under a
    mesh (module docstring); a restore places the state as the initial
    state is placed (``ft.runner.run``).
    """
    dev = resolve_device(device)
    chunked = engine_cfg.chunk_steps > 1
    if chunked and batches is not None:
        raise ValueError(
            "chunk_steps > 1 stages batches on the device from the (stream, "
            "seed) pair: pass those instead of a host batches factory, so "
            "that chunked and stepwise runs draw identical batches")
    if stream is None:
        stream = default_stream(fns.cfg, batch_size)
    if chunked:
        step_fn = None  # the chunked runner never calls the stepwise step
        chunk_fn, init_state = build_chunk_fn(fns, engine_cfg, stream, seed,
                                              device=dev, rules=rules)
        batch_size = stream.batch_size
    else:
        chunk_fn = None
        step_fn, init_state = build(fns, engine_cfg, rules)
        if batches is None:
            batches = make_batch_factory(stream, seed, device=dev)
            batch_size = stream.batch_size
        batches = _placed(batches, batch_placer(engine_cfg, rules))
    state0 = init_state(torch.Generator(device=dev).manual_seed(init_seed))

    resume0 = latest_step(runner_cfg.ckpt_dir) or 0
    executed = 0  # steps run by THIS call (a resume skips earlier ones)
    count_metrics = None
    if on_metrics is not None:
        def count_metrics(step, metrics, dt):
            nonlocal executed
            executed += 1
            on_metrics(step, metrics, dt)

    t0 = time.perf_counter()
    state, step = run(step_fn, state0, batches, runner_cfg, device=dev,
                      on_metrics=count_metrics,
                      chunk_fn=chunk_fn, chunk_steps=engine_cfg.chunk_steps)
    wall = time.perf_counter() - t0
    if on_metrics is None:
        # no callback, no per-step ticks: count from the resume point
        # (steps repeated after a staged crash are not counted then)
        executed = step - resume0
    info = {"wall_seconds": wall, "steps_executed": executed,
            "samples_per_s": executed * batch_size / max(wall, 1e-9)}
    return state, step, info

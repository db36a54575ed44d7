"""Training launcher of the port (counterpart of ``repro.launch.train``): the
MRF nets and the LMs.

    python -m repro_torch.launch.train --arch mrf-fpga --backend fused \\
        --optimizer sgd --tile-batch 128 --chunk-steps 50 --steps 200 \\
        --batch 256 --device cuda
    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 5 \\
        --batch 8 --seq 2048

MRF: config -> model -> engine (``float`` | ``qat-int8`` | ``fused``, the
last the JAX package's ``fused-pallas``) -> fault-tolerant runner
(checkpoints, restart, straggler watchdog) -> metrics log.  ``--chunk-steps
N`` runs N steps per dispatch (for ``fused``: one kernel launch),
bit-identical to stepwise.  ``--smoke`` takes the reduced config (16
frames).  The last line printed is ``train_report {json}``: the first and
last step losses, samples/s and the Table 1 errors of the trained net on
1,000 held-out signals.

LM (the reference's LM branch; every LM family: dense, MoE, SSM, hybrid,
encoder-decoder and VLM): weights from seed 0 (f32 masters), byte-level
batches of ``--batch`` x ``--seq`` tokens from ``data.lm_text.TextPipeline``
(vocab capped at 256); the VLM's prefix embeddings and the encoder-
decoder's frames ``0.02 * N(0, 1)`` in bf16 from a ``torch.Generator``
seeded by the step (the reference draws them with ``jax.random.PRNGKey
(step)``, whose threefry bits no torch generator repeats), the prefix's
positions' labels at -1, the frames ``(B, enc_len_for(seq), d)``; the
family's loss (activations in bf16, each block recomputed in the backward
but the hybrid's, attention on B6 and B6-bwd), ``--quant qat-int8`` the
paper's int8 QAT on every dense projection (``models.common.dense``), Adam,
clipping at a global norm of 1.0, ``--microbatches`` (the frames cut along
with the tokens) and ``--grad-compress`` as the reference, under the same
runner.  On the card the run is deterministic:
``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts (when this module is
run, or by a caller such as ``chip_smoke.py``) and the run holds
``torch.use_deterministic_algorithms(True)`` (the embedding's gradient
would otherwise scatter with atomics; the SSD scan's prefix sums are f64
products, ``models.ssm.prefix_sum``), so a rerun and a crash + restart
repeat the losses and the weights bit for bit, as XLA's do on the TPU.
The last line is ``train_report {json}``: the per-step losses (and every
logged loss in order, ``loss_log``: a restart logs the replayed steps
again), the MoE balance term's last value, tokens/s and ms a step (the
median of the steps after the first), the runner's wall time (steps,
checkpoints and restores), peak device memory, B6's and B6-bwd's
launches, the train-step calls and a digest of the final params' bits.
``--quant qat-int8`` on an MRF arch is ``--backend qat-int8`` (refused
beside ``--backend fused``), as in the reference.

``--mesh single|multi`` (the reference's ``_mesh_context``) runs under
``torchrun``: the process group comes from its environment (NCCL on the
card, gloo on the CPU; a group made by the caller is used as it is), the
mesh from ``launch.mesh.make_production_mesh`` and the rules from
``rules_for(mesh, global_batch=--batch)``, ambient for the run.  The LM's
params and Adam moments are DTensors placed by ``fns.param_axes()`` (heads
padded for the mesh's ``model`` size), and each batch by
``input_specs.batch_axes``: every rank draws the step's global batch and
keeps the rows of its data coordinate, so the data ranks' rows together
are the mesh-less batch (the reference instead folds the process index
into the data key).  Every LM family runs under the mesh: the MoE's
experts over ``model`` (``models.moe``), the SSM and hybrid mixers' heads
over ``model`` (``models.ssm``), the encoder-decoder's encoder, self- and
cross-attention and the VLM's prefix per rank; ``--grad-compress`` too
(the int8 scale of each leaf is the whole leaf's; ``TrainState.
ef_residual`` is placed as the params).  The MRF nets run data-parallel
(``float``, ``qat-int8``) or, for ``fused``, the kernel on the whole
batch on every rank (``train.engine``).  Without a process group, or with
``--device cuda`` and no card, ``--mesh`` raises.  ``torchrun --standalone
--nproc-per-node 1 -m repro_torch.launch.train --mesh single`` is the
``(data=1, model=1)`` mesh: the same DTensor path, with no collective
crossing a card, and the mesh-less run's bits.  ``--layers N`` trains an
LM's first N layers at full width (a depth cut).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import statistics
import tempfile
import time
from functools import partial
from typing import NamedTuple

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels.common import resolve_device

#: cuBLAS's workspace setting under which its products are deterministic;
#: it must be in the environment before CUDA starts
CUBLAS_DETERMINISTIC = ":4096:8"
#: the CUDA caching allocator's setting for training at full width: fixed
#: segments fragment under a step's large activations of changing shapes
#: (the MoE dispatch, a 256k-column head) until a step no longer fits
ALLOC_CONF = "expandable_segments:True"


def mesh_rules(args, device):
    """The run's mesh-bound rules, or None for ``--mesh none``: the process
    group from ``torchrun``'s environment when none exists, the production
    mesh over it, ``rules_for`` at the global batch."""
    if args.mesh == "none":
        return None
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh, rules_for
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"--mesh {args.mesh} needs a process group: run under "
                f"torchrun (e.g. torchrun --standalone --nproc-per-node 1 -m "
                f"repro_torch.launch.train ... --mesh {args.mesh})")
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        # NCCL sets its communicator up now, on an empty card: at a
        # full-width step's peak memory there is no room left for it
        dist.barrier(device_ids=[torch.cuda.current_device()])
    mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                device_type=device.type)
    return rules_for(mesh, global_batch=args.batch)


def _mesh_report(rules, state) -> dict:
    """What the run's state was: the mesh and how many leaves are
    DTensors (all of the params and moments under ``--mesh``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import leaves
    if rules is None:
        return {"mesh": None}
    mesh = rules.mesh
    all_leaves = leaves(state)
    return {"mesh": dict(zip(mesh.mesh_dim_names, map(int, mesh.shape))),
            "state_leaves": len(all_leaves),
            "dtensor_leaves": sum(isinstance(t, DTensor)
                                  for t in all_leaves)}


def _value(t) -> float:
    """A metric's value: a DTensor gathered first."""
    from torch.distributed.tensor import DTensor
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def use_rules_of(rules):
    """``use_rules(rules)``, or a null context without a mesh."""
    from repro_torch.dist.sharding import use_rules
    return contextlib.nullcontext() if rules is None else use_rules(rules)


def train_mrf(args, cfg) -> int:
    """The MRF nets through the engine: one runner, three backends, stepwise
    or chunked (the JAX package's ``run_mrf``)."""
    from repro_torch.core.mrf_net import layer_sizes
    from repro_torch.core.train_loop import evaluate
    from repro_torch.dist.sharding import full_tree
    from repro_torch.ft.checkpoint import latest_step
    from repro_torch.ft.runner import RunnerConfig
    from repro_torch.models.mrf import build_mrf
    from repro_torch.train import engine

    backend = args.backend
    if args.quant == "qat-int8":  # the LM zoo's spelling of the same request
        if backend == "fused":
            raise SystemExit("--quant qat-int8 conflicts with --backend fused "
                             "(the kernel's QAT is another path); drop one "
                             "of the flags")
        backend = "qat-int8"
    optimizer = args.optimizer or ("sgd" if backend == "fused" else "adam")
    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or str(pathlib.Path(tempfile.gettempdir())
                                    / "repro_torch_ckpt"
                                    / f"{cfg.name}-{backend}")
    resume = latest_step(ckpt_dir)
    if resume:
        print(f"resuming from checkpoint step {resume} in {ckpt_dir}")

    fns = build_mrf(cfg)
    rules = mesh_rules(args, device)
    ecfg = engine.EngineConfig(
        backend=backend, lr=args.lr, optimizer=optimizer,
        microbatches=args.microbatches, grad_compress=args.grad_compress,
        tile_batch=args.tile_batch, chunk_steps=args.chunk_steps)
    stream = engine.default_stream(cfg, args.batch)
    rcfg = RunnerConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                        ckpt_every=args.ckpt_every,
                        inject_fault_at=args.inject_fault_at)
    sizes = layer_sizes(cfg.mrf_n_frames, cfg.mrf_hidden)
    n_params = sum(k * n + n for k, n in zip(sizes[:-1], sizes[1:]))
    print(f"arch={cfg.name} backend={backend} optimizer={optimizer} "
          f"params={n_params:,} chunk_steps={args.chunk_steps} "
          f"device={device} mesh={args.mesh}")

    losses = {}

    def log(step, metrics, dt):
        if step == 1 or step % 10 == 0 or step == args.steps:
            losses[step] = _value(metrics["loss"])
            print(f"step {step:5d} loss {losses[step]:.6f} {dt * 1e3:.2f} ms",
                  flush=True)

    with use_rules_of(rules):
        state, step, info = engine.train(
            fns, ecfg, rcfg, stream=stream, seed=1, init_seed=0,
            batch_size=args.batch, on_metrics=log, device=device,
            rules=rules)
    mesh_info = _mesh_report(rules, state)
    state = full_tree(state)  # evaluated and digested whole on every rank
    # qat-int8 carries its observers in state.aux: evaluate the fake-quant
    # net the backend trained, not the float forward
    m = evaluate(state.params, stream.seq, qstate=state.aux, n=1000,
                 device=device)
    print(f"done at step {step}: {info['samples_per_s']:.0f} samples/s; "
          f"T1 MAPE {m['T1']['MAPE_%']:.2f}%  T2 MAPE {m['T2']['MAPE_%']:.2f}%")
    logged = sorted(losses)
    report = {"arch": cfg.name, "backend": backend, "optimizer": optimizer,
              "device": str(device), "steps": step,
              "steps_executed": info["steps_executed"],
              "first_loss": losses[logged[0]] if logged else None,
              "last_loss": losses[logged[-1]] if logged else None,
              "samples_per_s": info["samples_per_s"],
              "wall_s": info["wall_seconds"],
              "T1_MAPE_%": m["T1"]["MAPE_%"], "T2_MAPE_%": m["T2"]["MAPE_%"],
              "params_digest": params_digest(state.params), **mesh_info}
    print("train_report " + json.dumps(report))
    return 0


def lm_batches(cfg, pipe, device):
    """``step -> batch`` on ``device`` (the reference's ``make_batches``):
    the pipeline's tokens and labels as int64; for the VLM family
    ``prefix_embeds`` (B, n_prefix_embeds, d) over positions whose labels
    are -1, for the encoder-decoder ``frames`` (B, enc_len_for(S), d), both
    bf16 from a generator seeded by the step."""
    from repro_torch.models.common import COMPUTE
    from repro_torch.models.encdec import enc_len_for

    def normal(step, rows):
        gen = torch.Generator(device=device).manual_seed(step)
        return (0.02 * torch.randn((pipe.batch_size, rows, cfg.d_model),
                                   generator=gen, device=device)).to(COMPUTE)

    def at(step: int) -> dict:
        host = pipe.batch_at(step)
        if cfg.family == "vlm":
            host["labels"][:, :cfg.n_prefix_embeds] = -1
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in host.items()}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = normal(step, cfg.n_prefix_embeds)
        if cfg.family == "encdec":
            batch["frames"] = normal(step, enc_len_for(host["tokens"].shape[1]))
        return batch
    return at


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the run, the old
    setting restored after.  On a card, CUDA must not have started before
    ``CUBLAS_WORKSPACE_CONFIG`` was set (this module sets it when run;
    raises otherwise, rather than run a step that may not repeat)."""
    if torch.cuda.is_initialized() and \
            os.environ.get("CUBLAS_WORKSPACE_CONFIG") != CUBLAS_DETERMINISTIC:
        raise RuntimeError(
            f"LM training on the card needs CUBLAS_WORKSPACE_CONFIG="
            f"{CUBLAS_DETERMINISTIC} set before CUDA starts")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def _placed_lm_batches(batches, axes, rules):
    from repro_torch.dist.sharding import distribute_tree
    return lambda step: distribute_tree(batches(step), axes, rules)


def params_digest(params) -> int:
    """A digest of the params' bits: each leaf's 32-bit words summed as
    int64 (exact in any order), the leaves weighted by their position,
    modulo 2^61 - 1 (a DTensor leaf gathered whole first).  Equal digests
    of two runs mean, to all practical purposes, the same weights bit for
    bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import leaves

    total = 0
    for i, leaf in enumerate(leaves(params)):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        words = leaf.detach().contiguous().view(torch.int32).to(torch.int64)
        total = (total + (i + 1) * int(words.sum())) % (2 ** 61 - 1)
    return total


def warm_backward(device) -> None:
    """One small product differentiated on ``device`` before a run: the
    autograd engine's device thread creates its cuBLAS handle and
    workspace now, on an empty card.  A fresh process otherwise creates
    them in its first step's backward, at the step's peak memory, where a
    full-width step may leave no room (``cublasCreate`` fails)."""
    a = torch.ones((8, 8), device=device, requires_grad=True)
    torch.autograd.grad(torch.matmul(a, a).sum(), a)


class LmRun(NamedTuple):
    """What :func:`lm_job` hands back."""
    state: object       # the TrainState after the last step
    step: int           # the runner's last step
    losses: dict        # step -> loss (a replayed step's last value)
    grad_norms: dict    # step -> the global gradient norm before clipping
    times: dict         # step -> the step's wall seconds
    loss_log: list      # [step, loss] in logged order, replays included
    calls: int          # train-step calls, replays included
    balance: float | None  # the MoE balance term's last value
    wall_s: float       # the runner's wall time


def lm_job(cfg, *, batch: int, seq: int, steps: int, ckpt_dir: str,
           ckpt_every: int = 100, lr: float = 3e-4, microbatches: int = 1,
           grad_compress: bool = False, inject_fault_at: int | None = None,
           device="cuda", rules=None, seed: int = 0, data_seed: int = 0,
           on_step=None) -> LmRun:
    """An LM training job to ``steps`` (module docstring): ``cfg``'s model
    from weights drawn with ``seed`` (f32 masters, placed by
    ``fns.param_axes()`` under ``rules``), ``TextPipeline`` batches of
    ``batch`` x ``seq`` tokens seeded by ``data_seed``, Adam at ``lr``
    with clipping at a global norm of 1.0, under the fault-tolerant runner
    with its checkpoints in ``ckpt_dir`` (resumed from, when it holds one)
    every ``ckpt_every`` steps, all under deterministic algorithms.
    ``on_step(step, loss, grad_norm, seconds)`` after each step.  The
    launcher's LM branch and the benchmark's LM harness both run this."""
    from repro_torch.data.lm_text import TextPipeline
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.ft.runner import RunnerConfig, run
    from repro_torch.launch.input_specs import batch_axes
    from repro_torch.models import registry
    from repro_torch.optim import adam
    from repro_torch.train.step import init_train_state, make_train_step

    device = resolve_device(device)
    tp = 1 if rules is None else int(rules.mesh["model"].size())
    with deterministic(), use_rules_of(rules):
        fns = registry.build(cfg, tp)
        terms = {}  # the MoE balance term of the last loss evaluated
        loss_fn = partial(fns.loss, terms=terms) if cfg.family == "moe" \
            else fns.loss
        opt = adam(lr)
        step_fn = make_train_step(loss_fn, opt, microbatches=microbatches,
                                  max_grad_norm=1.0,
                                  grad_compress=grad_compress)
        calls = [0]

        def counted_step(state, batch_):
            calls[0] += 1
            return step_fn(state, batch_)

        pipe = TextPipeline(seq_len=seq, batch_size=batch,
                            vocab_size=min(cfg.vocab_size, 256),
                            seed=data_seed)
        rcfg = RunnerConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                            ckpt_every=ckpt_every,
                            inject_fault_at=inject_fault_at)
        losses, norms, times, loss_log = {}, {}, {}, []

        def log(step, metrics, dt):
            losses[step] = _value(metrics["loss"])
            norms[step] = _value(metrics["grad_norm"])
            times[step] = dt
            loss_log.append([step, losses[step]])
            if on_step is not None:
                on_step(step, losses[step], norms[step], dt)

        def init_state():
            params = fns.init(seed, device=device)
            if rules is not None:
                params = distribute_tree(params, fns.param_axes(), rules)
            return init_train_state(params, opt,
                                    grad_compress=grad_compress)

        batches = lm_batches(cfg, pipe, device)
        if rules is not None:  # each data rank keeps its rows
            batches = _placed_lm_batches(batches, batch_axes(cfg), rules)

        if device.type == "cuda":
            warm_backward(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        # the runner makes the initial state and holds it no longer than
        # it needs it: one state on the card, not two
        state, step = run(counted_step, init_state, batches, rcfg,
                          device=device, on_metrics=log)
        wall = time.perf_counter() - t0
    return LmRun(state=state, step=step, losses=losses, grad_norms=norms,
                 times=times, loss_log=loss_log, calls=calls[0],
                 balance=(_value(terms["balance"]) if "balance" in terms
                          else None), wall_s=wall)


def train_lm(args, cfg) -> int:
    """The LM branch: the reference's ``main`` past its MRF dispatch, one
    :func:`lm_job` and its report."""
    from repro_torch.configs.base import param_count
    from repro_torch.ft.checkpoint import latest_step
    from repro_torch.kernels.flash_attn.kernel import (
        flash_attention_bwd_call, flash_attention_call)
    from repro_torch.models.moe import group_of

    if args.quant:
        cfg = dataclasses.replace(cfg, quant=args.quant)
    device = resolve_device(args.device)
    if cfg.family == "vlm" and args.seq < cfg.n_prefix_embeds:
        raise SystemExit(f"--seq {args.seq}: a {cfg.name} sequence holds its "
                         f"{cfg.n_prefix_embeds} prefix embeddings")
    if cfg.family == "moe":  # each microbatch's tokens route in groups
        try:
            group_of(args.batch // max(args.microbatches, 1) * args.seq)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    ckpt_dir = args.ckpt_dir or str(pathlib.Path(tempfile.gettempdir())
                                    / "repro_torch_ckpt" / cfg.name)
    resume = latest_step(ckpt_dir) if args.ckpt_every > 0 else None
    if resume:
        print(f"resuming from checkpoint step {resume} in {ckpt_dir}")
    rules = mesh_rules(args, device)
    tp = 1 if rules is None else int(rules.mesh["model"].size())
    print(f"arch={cfg.name} params={param_count(cfg):,} tp={tp} "
          f"device={device} batch={args.batch} seq={args.seq} "
          f"microbatches={args.microbatches} quant={cfg.quant} "
          f"mesh={args.mesh}")

    def log(step, loss, gnorm, dt):
        print(f"step {step:5d} loss {loss:.6f} gnorm {gnorm:.4f} "
              f"{dt * 1e3:.1f} ms", flush=True)

    launches = (flash_attention_call.launches,
                flash_attention_bwd_call.launches)
    out = lm_job(cfg, batch=args.batch, seq=args.seq, steps=args.steps,
                 ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr,
                 microbatches=args.microbatches,
                 grad_compress=args.grad_compress,
                 inject_fault_at=args.inject_fault_at, device=device,
                 rules=rules, on_step=log)
    losses, times, step = out.losses, out.times, out.step
    steady = [times[s] for s in sorted(times)[1:]] or list(times.values())
    ms = statistics.median(steady) * 1e3 if steady else None
    report = {"arch": cfg.name, "device": str(device), "steps": step,
              "batch": args.batch, "seq": args.seq,
              "microbatches": args.microbatches, "quant": cfg.quant,
              "balance_loss": out.balance,
              "losses": {str(k): losses[k] for k in sorted(losses)},
              "loss_log": out.loss_log,
              "first_loss": losses[min(losses)] if losses else None,
              "last_loss": losses[max(losses)] if losses else None,
              "ms_per_step": ms,
              "step_ms": [times[k] * 1e3 for k in sorted(times)],
              "tokens_per_s": (args.batch * args.seq / ms * 1e3
                               if ms else None),
              "peak_device_gib": (torch.cuda.max_memory_allocated(device)
                                  / 2 ** 30 if device.type == "cuda"
                                  else None),
              "train_step_calls": out.calls,
              "wall_s": out.wall_s,
              "flash_attn_launches": flash_attention_call.launches
              - launches[0],
              "flash_attn_bwd_launches": flash_attention_bwd_call.launches
              - launches[1],
              "params_digest": params_digest(out.state.params),
              **_mesh_report(rules, out.state)}
    print(f"done at step {step}")
    print("train_report " + json.dumps(report))
    return 0


def parser() -> argparse.ArgumentParser:
    """The launcher's arguments (``main``'s; ``--layers`` is the one way
    to cut an LM in depth)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True,
                    help="mrf-fpga | mrf-original, or an LM arch of any "
                         "family")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (16 frames)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 256 (MRF), 8 (LM)")
    ap.add_argument("--seq", type=int, default=128,
                    help="LM sequence length (tokens)")
    ap.add_argument("--layers", type=int, default=0,
                    help="LM depth cut: the arch's first N layers (an "
                         "encoder-decoder's first N decoder layers), every "
                         "width kept; 0: all")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation over M equal slices of a "
                         "batch (not with --backend fused)")
    ap.add_argument("--backend", default="float",
                    choices=["float", "qat-int8", "fused"],
                    help="engine backend; fused = the whole-step CUDA "
                         "kernel (the JAX package's fused-pallas)")
    ap.add_argument("--optimizer", default=None, choices=["adam", "sgd"],
                    help="default: adam (sgd for the fused backend)")
    ap.add_argument("--tile-batch", type=int, default=128,
                    help="fused batch tile (1 = per-sample SGD)")
    ap.add_argument("--chunk-steps", type=int, default=1,
                    help="train steps per dispatch: > 1 stages N steps' "
                         "batches and, for fused, makes one kernel launch "
                         "(bit-identical to stepwise; 1 = stepwise)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 error-feedback gradient compression (not "
                         "with --backend fused)")
    ap.add_argument("--quant", default=None, choices=[None, "qat-int8"],
                    help="the paper's int8 QAT: fake-quant on every dense "
                         "projection of an LM; on an MRF arch the same as "
                         "--backend qat-int8")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: <tmp>/repro_torch_ckpt/<arch>[-<backend>] "
                         "(a rerun resumes from it)")
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="steps between checkpoints; 0: none, not even the "
                         "step-0 one (a crash restarts from the initial "
                         "state)")
    ap.add_argument("--inject-fault-at", type=int, default=None,
                    help="crash once at this step and restart from the "
                         "latest checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none",
                    help="run sharded under torchrun on the production "
                         "mesh (single: data x model; multi: pod x data x "
                         "model); none: one device, no mesh")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        if cfg.family == "mrf" or not 0 < args.layers <= cfg.n_layers:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} is an MRF "
                             f"net or has {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.family != "mrf":
        args.batch = 8 if args.batch is None else args.batch
        return train_lm(args, cfg)
    args.batch = 256 if args.batch is None else args.batch
    return train_mrf(args, cfg)


if __name__ == "__main__":
    # before CUDA starts: LM training runs deterministic cuBLAS products in
    # expandable segments (``ALLOC_CONF``)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
    raise SystemExit(main())

"""Training launcher of the port: the MRF branch of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch mrf-fpga --backend fused \\
        --optimizer sgd --tile-batch 128 --chunk-steps 50 --steps 200 \\
        --batch 256 --device cuda

Config -> model -> engine (``float`` | ``qat-int8`` | ``fused``, the last
the JAX package's ``fused-pallas``) -> fault-tolerant runner (checkpoints,
restart, straggler watchdog) -> metrics log.  ``--chunk-steps N`` runs N
steps per dispatch (for ``fused``: one kernel launch), bit-identical to
stepwise.  ``--smoke`` takes the reduced config (16 frames).

The last line printed is ``train_report {json}``: the first and last step
losses, samples/s and the Table 1 errors of the trained net on 1,000
held-out signals.  LM archs are refused: LM training arrives with a later
slice (the port serves the dense family, ``launch/serve.py``); so does
``--grad-compress``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile

from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels.common import resolve_device


def train_mrf(args, cfg) -> int:
    """The MRF nets through the engine: one runner, three backends, stepwise
    or chunked (the JAX package's ``run_mrf``)."""
    from repro_torch.core.mrf_net import layer_sizes
    from repro_torch.core.train_loop import evaluate
    from repro_torch.ft.checkpoint import latest_step
    from repro_torch.ft.runner import RunnerConfig
    from repro_torch.models.mrf import build_mrf
    from repro_torch.train import engine

    backend = args.backend
    optimizer = args.optimizer or ("sgd" if backend == "fused" else "adam")
    if args.grad_compress:
        raise SystemExit("--grad-compress needs optim/grad_compression.py, "
                         "which arrives with a later LM slice of the port")
    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or str(pathlib.Path(tempfile.gettempdir())
                                    / "repro_torch_ckpt"
                                    / f"{cfg.name}-{backend}")
    resume = latest_step(ckpt_dir)
    if resume:
        print(f"resuming from checkpoint step {resume} in {ckpt_dir}")

    fns = build_mrf(cfg)
    ecfg = engine.EngineConfig(
        backend=backend, lr=args.lr, optimizer=optimizer,
        tile_batch=args.tile_batch, chunk_steps=args.chunk_steps)
    stream = engine.default_stream(cfg, args.batch)
    rcfg = RunnerConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                        ckpt_every=args.ckpt_every,
                        inject_fault_at=args.inject_fault_at)
    sizes = layer_sizes(cfg.mrf_n_frames, cfg.mrf_hidden)
    n_params = sum(k * n + n for k, n in zip(sizes[:-1], sizes[1:]))
    print(f"arch={cfg.name} backend={backend} optimizer={optimizer} "
          f"params={n_params:,} chunk_steps={args.chunk_steps} "
          f"device={device}")

    losses = {}

    def log(step, metrics, dt):
        if step == 1 or step % 10 == 0 or step == args.steps:
            losses[step] = float(metrics["loss"])
            print(f"step {step:5d} loss {losses[step]:.6f} {dt * 1e3:.2f} ms",
                  flush=True)

    state, step, info = engine.train(
        fns, ecfg, rcfg, stream=stream, seed=1, init_seed=0,
        batch_size=args.batch, on_metrics=log, device=device)
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
              "T1_MAPE_%": m["T1"]["MAPE_%"], "T2_MAPE_%": m["T2"]["MAPE_%"]}
    print("train_report " + json.dumps(report))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True,
                    help="mrf-fpga | mrf-original (LM archs are refused)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (16 frames)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
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
                    help="int8 error-feedback gradient compression (arrives "
                         "with a later LM slice; raises)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: <tmp>/repro_torch_ckpt/<arch>-<backend> "
                         "(a rerun resumes from it)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--inject-fault-at", type=int, default=None,
                    help="crash once at this step and restart from the "
                         "latest checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family != "mrf":
        raise SystemExit(f"{cfg.name}: LM training arrives with a later slice "
                         f"of the port (ROADMAP.md §A); this slice serves it "
                         f"(python -m repro_torch.launch.serve)")
    return train_mrf(args, cfg)


if __name__ == "__main__":
    raise SystemExit(main())

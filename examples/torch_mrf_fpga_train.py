"""The paper's contribution on the port: training the MRF reconstruction
net ON the accelerator with the fused CUDA kernel (the net resident in
shared memory, samples streaming through), then the Eq. 3 comparison.

Two algorithms, never mixed up:
* ``--mode stream``: the paper's per-sample SGD stream (tile 1, one update
  a sample);
* ``--mode minibatch``: one update a tile of 128 samples (beyond the
  paper).

The loop is the port's engine (``train.engine`` -> ``ft.runner``) with the
``fused`` backend and checkpoints, as the reference's
``examples/mrf_fpga_train.py`` runs its ``fused-pallas`` backend: the
fused training kernel's K-step form (B2), launched once a step stepwise
(``--chunk-steps 1``) or once for K staged batches (``--chunk-steps K``).

Run:
    PYTHONPATH=src python examples/torch_mrf_fpga_train.py [--mode stream]
    PYTHONPATH=src python examples/torch_mrf_fpga_train.py --device cpu

The last line is ``eq3_report {json}``: the run's samples, wall seconds and
that wall time extrapolated to the paper's 250 M samples on the named
device, beside the paper's 200 s, the cycle model's and the H100 roofline
for the algorithm that ran.  The wall time holds everything the run did —
batch staging on the host and checkpoints too — so it is a rate of this
program, not of the kernel alone.
"""

import argparse
import json
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core import fpga_cost_model as fcm
from repro_torch.core import mrf_net
from repro_torch.core.metrics import table1_metrics_normalized
from repro_torch.data.pipeline import make_eval_set
from repro_torch.ft.runner import RunnerConfig
from repro_torch.kernels.common import disable_tf32, resolve_device
from repro_torch.kernels.fused_train.kernel import cluster_size
from repro_torch.kernels.fused_train.ops import effective_tile
from repro_torch.models import registry
from repro_torch.train import engine

PAPER_SAMPLES = fcm.PAPER["n_train_samples"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-2,
                    help="plain SGD (the paper's FPGA rule) needs a hotter "
                         "lr than Adam")
    ap.add_argument("--mode", choices=["minibatch", "stream"],
                    default="minibatch",
                    help="stream = the paper's per-sample SGD (tile 1); "
                         "minibatch = one update a tile of 128")
    ap.add_argument("--chunk-steps", type=int, default=1,
                    help=">1: K steps' batches staged and trained in one "
                         "launch (bit-identical to stepwise)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        disable_tf32()

    cfg = get_config("mrf-fpga")
    fns = registry.build(cfg)
    sizes = mrf_net.layer_sizes(cfg.mrf_n_frames, cfg.mrf_hidden)
    stream = engine.default_stream(cfg, args.batch)
    tile = 1 if args.mode == "stream" else 128
    tile_run = effective_tile(args.batch, tile)
    algorithm = fcm.train_algorithm(tile_run)

    print(f"fused on-accelerator training on {dev}: {args.mode} mode "
          f"({algorithm}), {args.steps} x {args.batch} samples, net {sizes}")
    ecfg = engine.EngineConfig(backend="fused", lr=args.lr, optimizer="sgd",
                               tile_batch=tile, chunk_steps=args.chunk_steps)
    losses = []

    def log(step, metrics, dt):
        if (step - 1) % 50 == 0 or step == args.steps:
            losses.append(float(metrics["loss"]))
            print(f"  step {step - 1:4d}  loss {losses[-1]:.6f}")

    with tempfile.TemporaryDirectory(prefix="mrf_fused_") as ckpt_dir:
        rcfg = RunnerConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                            ckpt_every=max(args.steps // 3, 1))
        state, _, info = engine.train(
            fns, ecfg, rcfg, stream=stream, seed=1, init_seed=0,
            batch_size=args.batch, on_metrics=log, device=dev)
    wall = info["wall_seconds"]
    n_samples = info["steps_executed"] * args.batch

    x, y = make_eval_set(stream.seq, n=2000, device=dev)
    with torch.no_grad():
        m = table1_metrics_normalized(mrf_net.forward(state.params, x), y)
    for p in ("T1", "T2"):
        print(f"  {p}: MAPE {m[p]['MAPE_%']:.2f}%  RMSE "
              f"{m[p]['RMSE_ms']:.0f} ms")

    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the host CPU (the kernel's plain PyTorch version)")
    cluster = cluster_size(tile_run, sizes)
    h100 = fcm.h100_train_seconds(sizes, PAPER_SAMPLES, tile=tile_run,
                                  cluster=cluster)
    report = {
        "mode": args.mode, "algorithm": algorithm, "tile": tile_run,
        "chunk_steps": args.chunk_steps, "steps": info["steps_executed"],
        "batch": args.batch, "samples": n_samples, "wall_s": wall,
        "device": where, "s_per_250m": wall / n_samples * PAPER_SAMPLES,
        "paper_fpga_s": fcm.paper_eq3_seconds(),
        "cycle_model_s": fcm.train_seconds(sizes, PAPER_SAMPLES),
        "h100_roofline_s": h100["t_total_s"],
        "h100_roofline_bound": h100["bound"], "cluster": cluster,
        "paper_cpu_s": fcm.PAPER["cpu_train_seconds"],
        "first_loss": losses[0], "last_loss": losses[-1]}

    print(f"\n=== Eq. 3 comparison ({PAPER_SAMPLES / 1e6:.0f}M samples) ===")
    print(f"  paper FPGA (200 MHz, 160 cyc/sample), per-sample stream: "
          f"{report['paper_fpga_s']:.0f} s")
    print(f"  our cycle model of the same design, per-sample stream: "
          f"{report['cycle_model_s']:.0f} s")
    print(f"  one H100's roofline, fused kernel on {cluster} of "
          f"{fcm.H100['n_sms']} SMs, {algorithm}: "
          f"{h100['t_total_s']:.1f} s ({h100['bound']}-bound)")
    print(f"  this run on {where}, {algorithm}: "
          f"{report['s_per_250m']:.0f} s extrapolated ({n_samples} samples "
          f"in {wall:.2f} s of wall time, staging and checkpoints included)")
    print("eq3_report " + json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Train a reduced-config LM under the full fault-tolerant runner
(checkpoints, resume, straggler watchdog), with a crash injected mid-run to
show the recovery, through ``repro_torch.launch.train`` (counterpart of
``examples/lm_train_smoke.py``).

Run:
    PYTHONPATH=src python examples/torch_lm_train_smoke.py          # on a card
    PYTHONPATH=src python examples/torch_lm_train_smoke.py --device cpu
    PYTHONPATH=src python examples/torch_lm_train_smoke.py \\
        --arch llava-next-34b

The smoke config of the arch (a dense or VLM one) trains on batches of 8 x
128 byte tokens; the runner crashes once at half the steps and restarts
from the latest checkpoint (every 50 steps).  The last line is the
launcher's ``train_report {json}``; its losses and params are those of a
run without the crash, bit for bit.
"""

import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as d:
        crash_at = args.steps // 2
        print(f"training {args.arch} (smoke) with a crash injected at step "
              f"{crash_at}: the runner must recover from the checkpoint")
        return train_main([
            "--arch", args.arch, "--smoke", "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt-dir", d, "--ckpt-every", str(args.ckpt_every),
            "--inject-fault-at", str(crash_at), "--device", args.device])


if __name__ == "__main__":
    import os

    # before CUDA starts: the training's cuBLAS products are deterministic
    from repro_torch.launch.train import CUBLAS_DETERMINISTIC
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC)
    raise SystemExit(main())

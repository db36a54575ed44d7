#!/usr/bin/env python3
"""Device time of the fused training kernel (B1, B2, B3) at each cluster
size, for the kernel of a given source tree: this checkout's, or another's
(a parent commit unpacked with ``git archive``), so that two versions are
compared in one run on one card.

    python3 scripts/fused_train_timing.py [--src DIR] [--label NAME]

Shapes as ``chip_smoke.py`` phase 5: B1 over 1,024 samples at tile 1, B2
and B3 over K=50 x 256 samples at tile 128, mrf-fpga; B2 and B3 also for
mrf-original.  At tile 1 with no cluster named ("default") a tree that has
it runs the per-sample kernel; a named cluster runs the cluster kernel.  Times are CUDA events around one call (median of 10 after 2
warm-ups, milliseconds).  A tree whose wrappers take no ``cluster`` (before
the cluster kernel) is timed at its one launch shape.  Prints one JSON
object a line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import statistics
import subprocess
import sys

import torch


def event_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_train_timing: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.core import mrf_net
    from repro_torch.kernels.common import disable_tf32
    from repro_torch.kernels.fused_train import kernel, multistep, ops

    disable_tf32()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    takes_cluster = "cluster" in inspect.signature(
        kernel.fused_train_call).parameters
    gen = torch.Generator(device=dev).manual_seed(0)
    x = 0.2 * torch.randn((12_800, 64), generator=gen, device=dev)
    y = torch.rand((12_800, 2), generator=gen, device=dev)
    step0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    for arch, hidden in (("mrf-fpga", mrf_net.ADAPTED_HIDDEN),
                         ("mrf-original", mrf_net.ORIGINAL_HIDDEN)):
        widths = mrf_net.layer_sizes(32, hidden)
        flat, _ = ops.pack_params(mrf_net.init_params(gen, widths))
        zeros = torch.zeros_like(flat)
        cases = {
            "fused_train_multistep": lambda kw: (
                multistep.fused_train_multistep_call(
                    x, y, flat, widths=widths, lr=1e-3, tile_batch=128, **kw)),
            "fused_train_adam": lambda kw: multistep.fused_train_adam_call(
                step0, x, y, flat, zeros, zeros, widths=widths, lr=1e-3,
                tile_batch=128, **kw)}
        if arch == "mrf-fpga":
            cases["fused_train"] = lambda kw: kernel.fused_train_call(
                x[:1024], y[:1024], flat, widths=widths, lr=1e-2,
                tile_batch=1, **kw)
        for name, call in cases.items():
            for cluster in ((None, 1, 2, 4, 8, 16) if takes_cluster
                            else (None,)):
                kw = {} if cluster is None else {"cluster": cluster}
                row = {"tree": args.label, "arch": arch, "kernel": name,
                       "cluster": cluster if cluster else "default",
                       "card": card}
                try:
                    row["ms"] = event_ms(lambda: call(kw))
                except (ValueError, RuntimeError) as e:
                    row["refused"] = str(e)[:120]
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

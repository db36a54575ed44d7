#!/usr/bin/env python3
"""Device time of the int8 serving kernels (B4 ``fused_forward``, B5
``qat_dense``) for the kernels of a given source tree: this checkout's, or
another's (a parent commit unpacked with ``git archive``), so that two
versions are compared in one run on one card.

    python3 scripts/int8_serving_timing.py [--src DIR] [--label NAME]

Shapes as ``chip_smoke.py`` phase 5: B4 over mrf-fpga with the denorm row,
B5 at the first hidden layer (K = N = 64, ReLU), each at M = 1,024 (the
served bucket) and M = 281,600 (a wave of 8 slices of 256 x 256).  The
net has random He-uniform weights from seed 0, QAT observers calibrated on
random features.  For each: ``ms``, the profiler's median device time of
the kernel over 30 back-to-back launches; ``wall_ms``, the median of 30
single calls between CUDA events; ``stream_ms``, CUDA events around 100
back-to-back calls, per call.  Prints one JSON object a line, with the
card's name and power limit; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch


def device_ms(fn, kernel: str, reps: int = 30) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA and kernel in e.name]
    if len(durs) < reps // 2:
        raise RuntimeError(f"the profiler saw {len(durs)} of {reps} "
                           f"launches of {kernel}")
    return statistics.median(durs) / 1e3


def wall_ms(fn, reps: int = 30) -> float:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_ms(fn, reps: int = 100) -> float:
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_serving_timing: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.core import mrf_net, qat
    from repro_torch.kernels.common import disable_tf32
    from repro_torch.kernels.qat_dense import fused, kernel, ops

    disable_tf32()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mrf_net.init_params(gen, mrf_net.layer_sizes(32))
    qs = qat.init_qat_state(len(params), device=dev)
    for _ in range(3):
        _, qs = qat.forward_qat(params, qs, torch.randn(
            (1024, 64), generator=gen, device=dev))
    net = ops.prepad_int_layers(qat.export_int8(params, qs))
    drow = torch.tensor([4000.0, 600.0], device=dev)
    w, b, s = net.packed[3:6]
    for m in (1024, 281_600):
        x = torch.randn((m, 64), generator=gen, device=dev)
        xq = torch.randint(-128, 128, (m, 64), generator=gen, device=dev,
                           dtype=torch.int8)
        cases = {
            "fused_forward": lambda: fused.fused_forward_call(  # noqa: E731
                x, net, drow=drow),
            "qat_dense": lambda: kernel.qat_dense_call(xq, w, b, s)}
        for name, call in cases.items():
            row = {"tree": args.label, "kernel": name, "m": m,
                   "ms": device_ms(call, f"{name}_kernel"),
                   "wall_ms": wall_ms(call), "stream_ms": stream_ms(call),
                   "card": card}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

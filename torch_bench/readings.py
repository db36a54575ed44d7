#!/usr/bin/env python3
"""The readings a cell's limits are set from (``limits/<cell>.json``).

    python3 torch_bench/readings.py --workload mrf-fpga.stream \\
        --seeds 101 102 103 ... --controls 3

For each seed: the program's side of the comparison (the cell's harness,
``harness/<family>_<kind>.py``, ``readings_of``) against the reference,
as a benchmark run compares them; for the first ``--controls`` seeds also
the control (for a training cell the reference in TF32 put in the
program's place) and the planted faults, each against the reference.
Prints a JSON line a seed and reading, then ``summary``: the largest
program reading of each number (the lower reading) and the smallest
control and fault readings (the upper ones).  Needs a CUDA card
unless ``--device cpu``; the benchmark's runs never run this.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(cell, seeds, controls: int, device, emit=print) -> dict:
    from torch_bench.harness import spec

    harness = spec.harness(cell)
    found = {}
    for i, seed in enumerate(seeds):
        for side, nums in harness.readings_of(cell, seed, device,
                                              i < controls).items():
            found.setdefault(side, []).append(nums)
            emit(json.dumps({"seed": seed, "side": side, **nums}))
    keys = [k for k, v in found["program"][0].items()
            if isinstance(v, float)]
    summary = {"lower": {k: max(r[k] for r in found["program"])
                         for k in keys}}
    for side, rows in found.items():
        if side != "program":
            summary[side] = {k: min(r[k] for r in rows) for k in keys}
    emit("summary " + json.dumps(summary))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from torch_bench.harness import spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    readings(spec.load_cell(args.workload), args.seeds, args.controls,
             torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""B6-bwd (the attention backward kernel, ``csrc/flash_attn_bwd.cu``) for
the kernels of a given source tree: this checkout's, or another's (a parent
commit unpacked with ``git archive``), so that two versions are compared in
one run on one card.

    python3 scripts/flash_attn_bwd_timing.py [--src DIR] [--label NAME]
        [--check] [--breakdown]

At tinyllama-1.1b's training shape (B 8, Hq 32, Hkv 4, dh 64, S 2,048,
causal, bf16) it prints ``ms``, the profiler's device time of one wrapper
call (both kernels, summed after a marker, as ``chip_smoke.device_ms``),
``wall_ms`` (CUDA events around one call, median of 10), and SDPA's
backward on the same inputs (``library_ms``), beside the bound of
``chip_smoke.b6_bwd_time`` and the two-kernel design's floor
(``chip_smoke.b6_bwd_floor_ms``, worked out from the shape), the device time of
each of the two kernels (``per_kernel_ms``), and B6 itself at the same
shape with and without its log-sum-exp (``forward_lse``).  ``--check``
first holds the tree's B6-bwd against its plain version within
``ref.bwd_bounds`` at every case of ``chip_smoke.bwd_cases`` (a launch
equal to its repeat, the planted faults caught); ``--breakdown`` also
profiles one training step of tinyllama-1.1b at 8 x 2,048 tokens by kernel
class (``chip_smoke.lm_train_breakdown``; ``chip_smoke.kernel_class``
knows B6-bwd by the old kernel names too).  The tree's ``nvcc`` report of B6-bwd (registers, spills) is
printed first.  One JSON object a line, with the card's name and power
limit; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

# before CUDA starts: the training step runs under deterministic algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def per_kernel(chip_smoke, device) -> dict:
    """The profiler's median device time of each of B6-bwd's two kernels
    at the training shape (the names hold ``dq_kernel<`` and
    ``dkdv_kernel<`` in either tree)."""
    from repro_torch.kernels.flash_attn import kernel

    qf, kf, vf, dof, kw = chip_smoke.bwd_inputs(chip_smoke.bwd_cases()[0],
                                                device, seed=29)
    a = {x: kw[x] for x in ("causal", "window", "group", "kv_len")}
    out, lse = kernel.flash_attention_call(qf, kf, vf, **kw, return_lse=True)
    call = lambda: kernel.flash_attention_bwd_call(  # noqa: E731
        qf, kf, vf, out, dof, lse, **a)
    return {name: chip_smoke.device_ms(call, name, reps=10, label=name)
            for name in ("dq_kernel<", "dkdv_kernel<")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attn_bwd_timing: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # puts this checkout's src first: --src goes before it

    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels.common import disable_tf32

    if not pathlib.Path(build.__file__).resolve().is_relative_to(
            pathlib.Path(args.src).resolve()):
        raise SystemExit(f"flash_attn_bwd_timing: repro_torch came from "
                         f"{build.__file__}, not {args.src}")
    disable_tf32()
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    logs = build.build(["flash_attn_sm90", "flash_attn_bwd"])
    for ln in logs["flash_attn_bwd"].splitlines():
        if any(w in ln for w in ("registers", "spill", "C75", "arning")):
            print(f"ptxas flash_attn_bwd ({args.label}): {ln.strip()}")
    if args.check:
        held = chip_smoke.check_flash_attention_bwd(device)
        print(json.dumps({"tree": args.label, "check": held, "card": card}),
              flush=True)
    row = chip_smoke.b6_bwd_time(float("nan"), device)
    keep = ("ms", "wall_ms", "library_ms", "bound_ms", "shape",
            "forward_lse")
    print(json.dumps({"tree": args.label, **{k: row.get(k) for k in keep},
                      "floor_ms": chip_smoke.b6_bwd_floor_ms(
                          chip_smoke.bwd_cases()[0]),
                      "per_kernel_ms": per_kernel(chip_smoke, device),
                      "card": card}), flush=True)
    if args.breakdown:
        out = chip_smoke.lm_train_breakdown(device)
        print(json.dumps({"tree": args.label, "train_step": out,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

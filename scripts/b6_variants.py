#!/usr/bin/env python3
"""What bounds B6's bf16 kernel (``csrc/flash_attn_sm90.cu``): times it
beside variants built from edited copies of its source, on one H100.

    python3 scripts/b6_variants.py       # from the repository root

Variants (each a text edit of the source, built into
``build/b6_variants/``; none is a correct kernel except ``kernel``):

* ``kernel``     — the source as it is;
* ``fast_exp``   — ``__expf`` (2 instructions, approximate) in place of the
  accurate ``expf`` (8): the accurate exp's share of the time;
* ``no_scale``   — the scale multiply of every score dropped: what one
  instruction a score costs;
* ``no_pingpong`` — the warpgroups issue their products without taking
  turns;
* ``no_softmax`` — the softmax step skipped (p = the scaled score): the
  products, loads and pipeline alone;
* ``stages_2`` / ``stages_4`` — the K/V ring at 2 or 4 stages (3 in the
  kernel): whether loads wait.

Each variant is timed with CUDA events around one launch (median of 30,
after 3 warm-ups), at the LM serving shape (B 8, Hq 32, Hkv 4, dh 64, S
2,048, causal), the same non-causal, and granite-8b's (Hkv 8, dh 128),
in two rounds.  Prints one JSON line a measurement and the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = (  # B, S, Hq, Hkv, dh, causal
    (8, 2048, 32, 4, 64, True),
    (8, 2048, 32, 4, 64, False),
    (8, 2048, 32, 8, 128, True),
)


def variants(src: str) -> dict:
    def edit(old: str, new: str) -> str:
        if old not in src:
            raise SystemExit(f"b6_variants: the source lost {old!r}")
        return src.replace(old, new)

    return {
        "kernel": src,
        "fast_exp": edit("expf(", "__expf("),
        "no_scale": edit("for (int i = 0; i < BK / 2; ++i) s[i] = "
                         "__fmul_rn(s[i], scale);", ""),
        "no_pingpong": edit('asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) '
                            ': "memory");', "").replace(
            'asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");',
            ""),
        "no_softmax": edit("  const bool edge = k_lo + BK > kv_len",
                           "  return;\n  const bool edge = k_lo + BK > "
                           "kv_len"),
        "stages_2": edit("constexpr int kStages = 3;",
                         "constexpr int kStages = 2;"),
        "stages_4": edit("constexpr int kStages = 3;",
                         "constexpr int kStages = 4;"),
    }


def event_ms(fn, reps: int = 30) -> float:
    for _ in range(3):
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
    if not torch.cuda.is_available():
        print("b6_variants: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn.ops import kernel_layout

    src = (build.CSRC / build.SOURCES["flash_attn_sm90"]).read_text()
    out = ROOT / "build" / "b6_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.cuda_tool(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"b6_variants: {name} did not build\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).flash_attn_sm90_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(1)
    for b, s, hq, hkv, dh, causal in SHAPES:
        q, k, v = (torch.randn((b, s, h, dh), generator=gen,
                               device=device).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal)
        o = torch.empty_like(qf)
        stream = torch.cuda.current_stream(device).cuda_stream
        for rnd in range(2):
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                             o.data_ptr(), None, None, qf.shape[0],
                             qf.shape[1],
                             kf.shape[1], dh, kw["group"], kw["kv_len"],
                             int(causal), 0, stream)
                    if err:
                        raise SystemExit(f"b6_variants: {name}: error {err}")
                print(json.dumps({"variant": name, "round": rnd,
                                  "shape": f"B {b}, Hq {hq}, Hkv {hkv}, dh "
                                           f"{dh}, S {s}, causal {causal}",
                                  "event_ms": event_ms(call)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

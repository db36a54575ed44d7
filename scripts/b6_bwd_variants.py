#!/usr/bin/env python3
"""What bounds B6-bwd (``csrc/flash_attn_bwd.cu``): times its two kernels
beside variants built from edited copies of the source, on one H100.

    python3 scripts/b6_bwd_variants.py       # from the repository root

Variants (each a text edit of the source, built into
``build/b6_bwd_variants/``; none is a correct kernel except ``kernel``):

* ``kernel``         — the source as it is;
* ``no_exp``         — ``expf`` dropped (p = s * scale - lse): the accurate
  exp's share;
* ``no_elementwise`` — the element-wise step of every tile skipped (the
  gradient products read whatever the operand registers hold): the
  products, loads and pipeline alone;
* ``no_delta``       — the dQ kernel's D from out and dout (device-memory
  loads at each item's start) skipped;
* ``no_mask``        — the masks never applied;
* ``stages_2``       — both rings at 2 stages (3 and 4 in the kernel):
  whether loads wait;
* ``no_pingpong``    — the warpgroups issue their products without taking
  turns.

Each variant's two kernels are timed by the profiler
(``chip_smoke.device_ms``: median device time of 10 launches of each,
after 2 warm-ups) at tinyllama-1.1b's training
shape (B 8, Hq 32, Hkv 4, dh 64, S 2,048, causal), in two rounds.  Prints
one JSON line a measurement and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def variants(src: str) -> dict:
    def edit(text: str, old: str, new: str) -> str:
        if old not in text:
            raise SystemExit(f"b6_bwd_variants: the source lost {old!r}")
        return text.replace(old, new)

    dq_loop = "for (int i = 0; i < BK / 2; i += 2) {"
    kv_loop = "for (int jj = 0; jj < kBq / 8; ++jj) {"
    return {
        "kernel": src,
        "no_exp": edit(src, "expf(", "("),
        "no_elementwise": edit(edit(src, dq_loop, dq_loop.replace(
            "i < BK / 2", "i < 0")), kv_loop, kv_loop.replace(
                "jj < kBq / 8", "jj < 0")),
        "no_delta": edit(edit(src, "deltas.load(out, dout, grow - g, lane);",
                              "d_r[0] = d_r[1] = 0.0f;"),
                         "deltas.reduce(delta, grow - g, lane, g, d_r);", ""),
        "no_mask": edit(src, "if (edge)\n", "if (false)\n"),
        "stages_2": edit(edit(src, "kStages = 3;  ", "kStages = 2;  "),
                         "kStages = 4;  ", "kStages = 2;  "),
        "no_pingpong": edit(edit(src, 'asm volatile("bar.sync %0, 256;" ::'
                                      '"r"(1 + wg) : "memory");', ""),
                            'asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg)'
                            ' : "memory");', ""),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("b6_bwd_variants: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn.kernel import flash_attention_call
    from repro_torch.kernels.flash_attn.ops import kernel_layout

    src = (build.CSRC / build.SOURCES["flash_attn_bwd"]).read_text()
    out = ROOT / "build" / "b6_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.cuda_tool(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"b6_bwd_variants: {name} did not build\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).flash_attn_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(29)
    b, s, hq, hkv, dh = 8, 2048, 32, 4, 64
    q, k, v, do = (torch.randn((b, s, h, dh), generator=gen,
                               device=device).to(torch.bfloat16)
                   for h in (hq, hkv, hkv, hq))
    qf, kf, vf, kw = kernel_layout(q, k, v)
    dof = kernel_layout(do, k, v)[0]
    o, lse = flash_attention_call(qf, kf, vf, **kw, return_lse=True)
    grads = [torch.empty_like(x) for x in (qf, kf, vf)]
    delta = torch.empty_like(lse)
    stream = torch.cuda.current_stream(device).cuda_stream
    for rnd in range(2):
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                err = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                         o.data_ptr(), dof.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), *(g.data_ptr() for g in grads),
                         qf.shape[0], s, s, dh, kw["group"], kw["kv_len"], 1,
                         0, stream)
                if err:
                    raise SystemExit(f"b6_bwd_variants: {name}: error {err}")
            print(json.dumps({
                "variant": name, "round": rnd,
                "shape": f"B {b}, Hq {hq}, Hkv {hkv}, dh {dh}, S {s}, causal",
                **{f"{k}_ms": chip_smoke.device_ms(
                    call, f"{k}_kernel<", reps=10, warmup=2,
                    label=f"{name} {k}") for k in ("dq", "dkdv")}}),
                flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

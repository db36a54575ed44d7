#!/usr/bin/env python3
"""Where a tile of the fused training kernel spends its cycles: builds an
instrumented copy of ``src/repro_torch/csrc/fused_train.cu`` (block 0,
thread 0 reads ``clock64()`` at the phase boundaries of the launch's third
tile), runs B1, B2 and B3 through the port's wrappers with that library, and
prints the cycles of each phase.

    python3 scripts/fused_train_phases.py

Phases: ``qat`` the fake-quant (and its barrier), ``fwdL`` layer L's
forward and its barrier, ``bwdL`` layer L's dh and partial dW/db and its
barrier, ``xchg_in`` the partials' exchange (bulk copies and the wait, or
the cluster barrier), ``owner`` thread 0's share of the update, ``xchg_out``
the new weights' exchange and the tile's end.  Counts are SM cycles of one
thread, so a phase includes its wait for the block's slowest warp.  The copy
and its library go to ``build/fused_train_phases/``; the kernel in ``src``
is not touched.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "fused_train_phases"
PROBES = [  # (anchor in the source, text put before it)
    ("namespace {\n", None),
    ("    // --- per-column int8 fake-quant", "    PROBE(0);\n"),
    ("    // --- forward, the last layer's epilogue", "    PROBE(1);\n"),
    ("      float* tmp = cur;", "      PROBE(20 + (n_layers - 1 - l));\n"),
    ("    // --- the loss, and the owners' update", "    PROBE(40);\n"),
    ("    cp_async_wait_all();\n    if (P.bulk) {  // every replica",
     "    PROBE(41);\n"),
]


def instrumented_source() -> str:
    s = (ROOT / "src/repro_torch/csrc/fused_train.cu").read_text()
    head = ("namespace {\n__device__ long long g_probe[128];\n"
            "#define PROBE(i) do { if (t == 2 && rank == 0 && tid == 0) "
            "g_probe[(i)] = clock64(); } while (0)\n")
    for anchor, text in PROBES:
        if anchor not in s:
            raise SystemExit(f"anchor not in the source: {anchor!r}")
        s = s.replace(anchor, head if text is None else text + anchor, 1)
    for old, new in (
            ("      __syncthreads();\n    }\n\n    // --- backward: dh",
             "      __syncthreads();\n      PROBE(2 + l);\n    }\n\n"
             "    // --- backward: dh"),
            ("      cluster_barrier(cluster, n_blocks);\n    }\n  }\n",
             "      cluster_barrier(cluster, n_blocks);\n    }\n"
             "    PROBE(99);\n  }\n")):
        if old not in s:
            raise SystemExit(f"anchor not in the source: {old!r}")
        s = s.replace(old, new, 1)
    return s + ('\nextern "C" int fused_train_probe_read(long long* out) {\n'
                "  return (int)cudaMemcpyFromSymbol(out, g_probe, "
                "sizeof(g_probe));\n}\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_train_phases: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import mrf_net
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_train import kernel, multistep, ops

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "fused_train_phases.cu", OUT / "libfused_train_phases.so"
    src.write_text(instrumented_source())
    subprocess.run([build.cuda_tool(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    fn = so.fused_train_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    kernel._entry = lambda: fn
    probe = (ctypes.c_longlong * 128)()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = 0.2 * torch.randn((12_800, 64), generator=gen, device=dev)
    y = torch.rand((12_800, 2), generator=gen, device=dev)
    step0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    for arch, hidden in (("mrf-fpga", mrf_net.ADAPTED_HIDDEN),
                         ("mrf-original", mrf_net.ORIGINAL_HIDDEN)):
        widths = mrf_net.layer_sizes(32, hidden)
        n_layers = len(widths) - 1
        flat, _ = ops.pack_params(mrf_net.init_params(gen, widths))
        zeros = torch.zeros_like(flat)
        runs = [
            ("B2 tile 128", lambda: multistep.fused_train_multistep_call(
                x, y, flat, widths=widths, lr=1e-3, tile_batch=128)),
            ("B2 tile 128 qat", lambda: multistep.fused_train_multistep_call(
                x, y, flat, widths=widths, lr=1e-3, tile_batch=128,
                qat=True)),
            ("B3 tile 128", lambda: multistep.fused_train_adam_call(
                step0, x, y, flat, zeros, zeros, widths=widths, lr=1e-3,
                tile_batch=128)),
            ("B1 tile 1", lambda: kernel.fused_train_call(
                x[:1024], y[:1024], flat, widths=widths, lr=1e-2,
                tile_batch=1))]
        for label, call in runs:
            call()
            torch.cuda.synchronize()
            so.fused_train_probe_read(probe)
            v = list(probe)
            names = [("qat", 1)] + [(f"fwd{l}", 2 + l) for l in
                                    range(n_layers)]
            names += [(f"bwd{l}", 20 + i) for i, l in
                      enumerate(range(n_layers - 1, -1, -1))]
            names += [("xchg_in", 40), ("owner", 41), ("xchg_out", 99)]
            prev, parts = v[0], []
            for name, i in names:
                parts.append(f"{name}={v[i] - prev}")
                prev = v[i]
            print(f"{arch} {label} cluster {kernel.run_fused_train.last_cluster}"
                  f": {v[99] - v[0]} cycles a tile: {' '.join(parts)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

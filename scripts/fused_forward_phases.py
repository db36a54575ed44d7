#!/usr/bin/env python3
"""Where a voxel tile of the fused int8 forward kernel (B4) spends its
cycles: builds an instrumented copy of
``src/repro_torch/csrc/fused_forward.cu`` (block 0, thread 0 reads
``clock64()`` at the phase boundaries of its warp's first tile, and at the
end of each of its first 32 tiles), runs B4 through the port's wrapper with
that library on mrf-fpga at M = 128, 1,024 and 281,600, and prints the
cycles of each phase.

    python3 scripts/fused_forward_phases.py

Phases of the first tile: ``start`` from the kernel's entry to the
mbarrier's set-up and the bulk copy's issue plus the first tile's feature
loads and quantization (thread 0's share of them when a tile has several
warps), ``image`` the wait for the image (and for the group's features),
``layerL`` layer L's products and epilogue (and the group's barrier).
``per tile``: the cycles between the ends of the warp's successive tiles.
Counts are SM cycles of one thread.  The copy and its library go to
``build/fused_forward_phases/``; the kernel in ``src`` is not touched.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "fused_forward_phases"
PROBES = [  # (anchor in the source, text put before it)
    ("namespace {\n", None),
    ("  const unsigned bar_addr = int8mma::cta_addr(&bar);\n",
     "  int tile_no = 0;\n  PROBE(0);\n"),
    ("    if (first) int8mma::mbar_wait(bar_addr, 0);\n", "    PROBE(1);\n"),
    ("    for (int l = 0; l < n_layers; ++l) {\n", "    PROBE(2);\n"),
    ("      const uint4 hdr = next;\n",
     "      if (l) PROBE(2 + l);\n"),
    ("    r0 += stride;\n",
     "    PROBE(2 + n_layers);\n"
     "    if (blockIdx.x == 0 && threadIdx.x == 0 && tile_no < 32) "
     "g_probe[64 + tile_no++] = clock64();\n"),
]


def instrumented_source() -> str:
    s = (ROOT / "src/repro_torch/csrc/fused_forward.cu").read_text()
    head = ("namespace {\n__device__ long long g_probe[128];\n"
            "#define PROBE(i) do { if (blockIdx.x == 0 && threadIdx.x == 0 "
            "&& r0 < stride) g_probe[(i)] = clock64(); } while (0)\n")
    for anchor, text in PROBES:
        if s.count(anchor) != 1:
            raise SystemExit(f"anchor not once in the source: {anchor!r}")
        s = s.replace(anchor, head if text is None else text + anchor, 1)
    return s + ('\nextern "C" int fused_forward_probe_read(long long* out) {\n'
                "  return (int)cudaMemcpyFromSymbol(out, g_probe, "
                "sizeof(g_probe));\n}\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_forward_phases: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import mrf_net, qat
    from repro_torch.kernels import build
    from repro_torch.kernels.qat_dense import fused, ops

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "fused_forward_phases.cu"
    lib = OUT / "libfused_forward_phases.so"
    src.write_text(instrumented_source())
    for header in build.included_headers("fused_forward.cu"):
        (OUT / header.name).write_bytes(header.read_bytes())
    subprocess.run([build.cuda_tool(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    fn = so.fused_forward_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fused._entry = lambda: fn
    probe = (ctypes.c_longlong * 128)()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mrf_net.init_params(gen, mrf_net.layer_sizes(32))
    qs = qat.init_qat_state(len(params), device=dev)
    for _ in range(3):
        _, qs = qat.forward_qat(params, qs, torch.randn(
            (1024, 64), generator=gen, device=dev))
    net = ops.prepad_int_layers(qat.export_int8(params, qs))
    drow = torch.tensor([4000.0, 600.0], device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    for m in (128, 1024, 281_600):
        x = torch.randn((m, 64), generator=gen, device=dev)
        for _ in range(3):  # the last launch's probes are read
            fused.fused_forward_call(x, net, drow=drow)
        torch.cuda.synchronize()
        so.fused_forward_probe_read(probe)
        v = list(probe)
        parts = [f"start={v[1] - v[0]}", f"image={v[2] - v[1]}"]
        parts += [f"layer{l}={v[3 + l] - v[2 + l]}"
                  for l in range(net.n_layers)]
        ends = [e for e in v[64:96] if e]
        per_tile = [b - a for a, b in zip(ends, ends[1:])]
        print(f"mrf-fpga M={m}: first tile {v[2 + net.n_layers] - v[0]} "
              f"cycles: {' '.join(parts)}; per tile after it: {per_tile}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

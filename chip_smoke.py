#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: builds the CUDA kernels,
holds each against its plain PyTorch version, serves MRF maps end to end
through ``repro_torch.launch.serve`` and times the kernels.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases (any failure raises, and the script exits non-zero without the
final result line):

1. device facts (name, capability, ``nvidia-smi`` name and power limit);
2. build the kernels from ``src/repro_torch/csrc`` with ``nvcc``;
3. each kernel against its plain version on identical tensors on the card,
   at the serving path's shapes (bit-exact: integer arithmetic);
4. a calibrated mrf-fpga int8 artifact (random He-uniform weights, QAT
   observer calibration on simulated fingerprints) served through the
   launcher — sync and pipelined via the fused kernel, sync via the
   layered kernel chain, and mrf-original via the fused kernel — each run
   checked bit for bit against the CPU integer oracle, with the kernels'
   launch counts read just before and after;
5. kernel times on the device (profiler, median of 30 launches) beside
   their bounds, their plain versions' device times and the wall time of
   one wrapper call between CUDA events.

The last two lines are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
REPS = 30
BUCKETS = (128, 256, 512, 1024)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def device_facts() -> tuple:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}  capability {cap[0]}.{cap[1]}  "
        f"count {torch.cuda.device_count()}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(smi)
    return name, smi


def calibrated_net(hidden, seed: int, device):
    """Random He-uniform weights, observers calibrated on simulated
    fingerprints, exported to int8 — serving needs no trained net."""
    from repro_torch.core import mrf_net, qat
    from repro_torch.data.epg import default_sequence
    from repro_torch.data.pipeline import MRFSampleStream, sample_batch

    gen = torch.Generator(device=device).manual_seed(seed)
    params = mrf_net.init_params(gen, mrf_net.layer_sizes(32, hidden))
    qs = qat.init_qat_state(len(params), device=device)
    stream = MRFSampleStream(seq=default_sequence(32), batch_size=1024)
    for _ in range(5):
        x, _ = sample_batch(stream, gen)
        _, qs = qat.forward_qat(params, qs, x)
    return qat.export_int8(params, qs)


def exact(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {got.dtype}{tuple(got.shape)} vs plain "
             f"{want.dtype}{tuple(want.shape)}")
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    if not torch.equal(got, want):
        fail(f"{what}: differs from its plain version (max abs err {err})")
    return err


def check_kernels(nets, device) -> dict:
    """Phase 3: B4 and B5 against their plain versions, bit-exact."""
    from repro_torch.kernels.qat_dense import fused, kernel, ops, ref

    errs = {"fused_forward": 0.0, "qat_dense": 0.0}
    drow = torch.tensor([4000.0, 600.0], device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    for arch, net in nets.items():
        for m in BUCKETS:
            x = torch.randn((m, net.in_dim), generator=gen, device=device)
            for d in (drow, None):
                before = fused.fused_forward_call.launches
                got = fused.fused_forward_call(x, net, drow=d)
                want = ref.ref_fused_forward(x, net.s_in, net.packed,
                                             net.out_dim, drow=d)
                torch.cuda.synchronize()
                if fused.fused_forward_call.launches != before + 1:
                    fail("fused_forward launch counter did not advance")
                errs["fused_forward"] = max(errs["fused_forward"], exact(
                    got, want, f"fused_forward {arch} M={m} "
                               f"denorm={d is not None}"))
        # every layer shape of the net at the largest bucket, as served
        for i in range(net.n_layers):
            w, b, s = net.packed[3 * i:3 * i + 3]
            last = i == net.n_layers - 1
            xq = torch.randint(-128, 128, (1024, w.shape[0]), generator=gen,
                               device=device, dtype=torch.int8)
            before = kernel.qat_dense_call.launches
            got = kernel.qat_dense_call(xq, w, b, s, relu=not last,
                                        float_out=last)
            want = ref.ref_qat_dense(xq, w, b, s, relu=not last,
                                     float_out=last)
            torch.cuda.synchronize()
            if kernel.qat_dense_call.launches != before + 1:
                fail("qat_dense launch counter did not advance")
            errs["qat_dense"] = max(errs["qat_dense"], exact(
                got, want, f"qat_dense {arch} layer {i} {tuple(w.shape)}"))
    # ragged M/N/K edges, every epilogue
    xq = torch.randint(-128, 128, (130, 200), generator=gen, device=device,
                       dtype=torch.int8)
    w = torch.randint(-128, 128, (200, 300), generator=gen, device=device,
                      dtype=torch.int8)
    b = torch.randint(-2048, 2048, (300,), generator=gen, device=device,
                      dtype=torch.int32)
    s = torch.rand((300,), generator=gen, device=device) * 1e-2 + 1e-4
    for relu, float_out in ((True, False), (False, False), (False, True)):
        got = ops.qat_dense(xq, w, b, s, relu=relu, float_out=float_out)
        want = ref.ref_qat_dense(xq, w, b, s, relu=relu, float_out=float_out)
        torch.cuda.synchronize()
        errs["qat_dense"] = max(errs["qat_dense"], exact(
            got, want, f"qat_dense ragged relu={relu} float_out={float_out}"))
    log(f"kernels == plain versions: bit-exact ({errs})")
    return errs


def serve(argv) -> dict:
    """One launcher run with the kernels' counts reset just before it;
    returns its report plus the counts read just after."""
    from repro_torch.kernels.qat_dense import fused, kernel
    from repro_torch.launch import serve as launcher

    fused.fused_forward_call.launches = 0
    kernel.qat_dense_call.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(argv)
    counts = {"fused_forward": fused.fused_forward_call.launches,
              "qat_dense": kernel.qat_dense_call.launches}
    out = buf.getvalue()
    log(out.rstrip())
    if rc != 0:
        fail(f"launcher {' '.join(argv)} returned {rc}")
    lines = [ln for ln in out.splitlines() if ln.startswith("serve_report ")]
    if not lines or "oracle: bit-exact" not in out:
        fail(f"launcher {' '.join(argv)}: no oracle check / report")
    report = json.loads(lines[-1].split(" ", 1)[1])
    report["launches"] = counts
    return report


def serve_phase(tmp: pathlib.Path, device) -> dict:
    """Phase 4: the port's main path through the launcher; returns each
    kernel's launches summed over the runs."""
    from repro_torch.core import mrf_net, qat

    paths = {}
    for arch, hidden in (("mrf-fpga", mrf_net.ADAPTED_HIDDEN),
                         ("mrf-original", mrf_net.ORIGINAL_HIDDEN)):
        paths[arch] = qat.save_int8_artifact(
            tmp / f"{arch}_int8", calibrated_net(hidden, 0, device))
    base = ["--backend", "int8", "--device", "cuda", "--phantom-n", "256"]
    runs = [
        ("mrf-fpga", "fused", "sync", 8),
        ("mrf-fpga", "fused", "pipelined", 8),
        ("mrf-fpga", "layered", "sync", 8),
        ("mrf-original", "fused", "sync", 2),
    ]
    launches = {"fused_forward": 0, "qat_dense": 0}
    for arch, impl, mode, n_req in runs:
        rep = serve(["--arch", arch, *base, "--artifact", str(paths[arch]),
                     "--int8-impl", impl, "--serve-mode", mode,
                     "--requests", str(n_req)])
        n_layers = 7 if arch == "mrf-fpga" else 9
        want = ({"fused_forward": rep["tiles"], "qat_dense": 0}
                if impl == "fused" else
                {"fused_forward": 0, "qat_dense": rep["tiles"] * n_layers})
        if rep["launches"] != want:
            fail(f"{arch} {impl} {mode}: launches {rep['launches']}, "
                 f"expected {want} for {rep['tiles']} tiles")
        for k, v in rep["launches"].items():
            launches[k] += v
        log(f"serve {arch} {impl} {mode}: {rep['voxels']} voxels, "
            f"{rep['voxels_per_s']} voxels/s, p50 {rep['p50_ms']} ms, "
            f"p99 {rep['p99_ms']} ms, {rep['tiles']} tiles, launches "
            f"{rep['launches']}")
    return launches


def event_ms(fn) -> float:
    """Median wall time of one call between CUDA events: the device time
    plus whatever host launch overhead keeps the card waiting."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str | None) -> float:
    """Device time per call from the profiler's CUDA activity: the median
    duration of ``kernel``'s launches, or (``kernel=None``) the summed
    duration of every device activity over REPS calls, per call.  Fails
    when the profiler records no device activity: wall time between CUDA
    events (:func:`event_ms`) is reported beside it, never in its place.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        fail("the profiler recorded no device activity: no device time")
    if kernel is None:
        return sum(e.time_range.elapsed_us() for e in evs) / REPS / 1e3
    durs = [e.time_range.elapsed_us() for e in evs if kernel in e.name]
    if len(durs) != REPS:
        fail(f"profiler saw {len(durs)} launches of {kernel}, expected {REPS}")
    return statistics.median(durs) / 1e3


def timing_phase(net, int_layers, launches: dict, errs: dict,
                 device) -> list:
    """Phase 5: B4 at bucket 1024 with the denorm row (as served), B5 at the
    first hidden layer's shape at M=1024.  B4's bound counts the net at its
    true widths (``int_layers``): int8 weights, int32 bias and fp32 scale per
    output, never the kernel's padded shared-memory image."""
    from repro_torch.kernels.qat_dense import fused, kernel, ref

    m = 1024
    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((m, net.in_dim), generator=gen, device=device)
    drow = torch.tensor([4000.0, 600.0], device=device)
    shapes = [tuple(int(d) for d in layer.w_q.shape) for layer in int_layers]
    b4_bytes = x.numel() * 4 + sum(k * n + 8 * n for k, n in shapes) \
        + drow.numel() * 4 + m * net.out_dim * 4
    b4_ops = 2 * m * sum(k * n for k, n in shapes)
    saved = fused.fused_forward_call.launches
    b4_call = lambda: fused.fused_forward_call(x, net, drow=drow)
    b4 = {"ms": device_ms(b4_call, "fused_forward_kernel"),
          "wall_ms": event_ms(b4_call),
          "plain_ms": device_ms(lambda: ref.ref_fused_forward(
              x, net.s_in, net.packed, net.out_dim, drow=drow), None)}
    fused.fused_forward_call.launches = saved

    w, b, s = net.packed[3:6]  # layer 1: (64, 64), ReLU epilogue
    xq = torch.randint(-128, 128, (m, w.shape[0]), generator=gen,
                       device=device, dtype=torch.int8)
    k, n = w.shape
    b5_bytes = m * k + k * n + 4 * n + 4 * n + m * n
    b5_ops = 2 * m * k * n
    saved = kernel.qat_dense_call.launches
    b5_call = lambda: kernel.qat_dense_call(xq, w, b, s)
    b5 = {"ms": device_ms(b5_call, "qat_dense_kernel"),
          "wall_ms": event_ms(b5_call),
          "plain_ms": device_ms(lambda: ref.ref_qat_dense(xq, w, b, s), None)}
    kernel.qat_dense_call.launches = saved

    rows = []
    for name, src, replaces, t, nbytes, nops in (
            ("fused_forward", "src/repro_torch/csrc/fused_forward.cu",
             "src/repro/kernels/qat_dense/fused.py:68", b4, b4_bytes, b4_ops),
            ("qat_dense", "src/repro_torch/csrc/qat_dense.cu",
             "src/repro/kernels/qat_dense/kernel.py:64", b5, b5_bytes,
             b5_ops)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / INT8_OPS_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": None, "wall_ms": t["wall_ms"],
                     "shape": (f"M={m}, mrf-fpga, denorm" if name == "fused_forward"
                               else f"M={m}, K={k}, N={n}, relu"),
                     "bytes": nbytes, "ops": nops})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke run needs an NVIDIA H100", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.common import disable_tf32
        from repro_torch.kernels.qat_dense import ops
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name, smi = device_facts()
    device = torch.device("cuda", 0)
    disable_tf32()
    build.check_device(device)

    t0 = time.perf_counter()
    logs = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)} "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for kname, text in logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "smem" in ln or "spill" in ln:
                log(f"  ptxas {kname}: {ln.strip()}")

    from repro_torch.core import mrf_net
    layers = {arch: calibrated_net(hidden, 1, device)
              for arch, hidden in (("mrf-fpga", mrf_net.ADAPTED_HIDDEN),
                                   ("mrf-original", mrf_net.ORIGINAL_HIDDEN))}
    nets = {arch: ops.prepad_int_layers(ls) for arch, ls in layers.items()}
    errs = check_kernels(nets, device)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = serve_phase(pathlib.Path(tmp), device)
    for kname, n in launches.items():
        if n <= 0:
            fail(f"kernel {kname} was never launched on the main path")

    rows = timing_phase(nets["mrf-fpga"], layers["mrf-fpga"], launches, errs,
                        device)
    for r in rows:
        log(f"time {r['name']} ({r['shape']}): {r['ms']:.6f} ms on the "
            f"device, {r['wall_ms']:.6f} ms per call, plain "
            f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})  [{smi}]")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Serving launcher of the port: the MRF reconstruction family
(counterpart of the MRF branch of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch mrf-fpga --backend int8
--artifact net.npz`` loads a servable int8 artifact (the ``.npz`` format of
``repro.core.qat.save_int8_artifact``, written by either package),
reconstructs a request wave of phantom slices through the queued engine on
``--device`` (default ``cuda``), and cross-checks every served map against
the plain integer oracle ``qat.int_forward`` — computed on a CPU copy, so
the check does not run through the kernel it checks — bit for bit.
``--serve-mode pipelined`` serves the same trace through the
double-buffered executor and also asserts that its maps are bit-identical
to sync serving.

The last line printed is ``serve_report {json}``: throughput, latency
percentiles and the tiles served.  QAT training (the source of artifacts
and of float weights) arrives with the training slice.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import qat
from repro_torch.data.epg import default_sequence
from repro_torch.data.phantom import acquire_slice, make_phantom, tissue_errors
from repro_torch.data.pipeline import denormalize_targets
from repro_torch.kernels.common import resolve_device
from repro_torch.serve.recon import (ReconEngine, ReconRequest,
                                     latency_percentiles)


def _maps_equal(a, b) -> bool:
    return np.array_equal(a.t1_ms, b.t1_ms) and np.array_equal(a.t2_ms, b.t2_ms)


def serve_mrf(args, cfg) -> int:
    """The MRF reconstruction family through the batched serving engine."""
    if args.backend == "float":
        raise SystemExit("--backend float needs float weights, which come "
                         "from training: it arrives with the training slice")
    if args.backend != "int8":
        raise SystemExit(f"--backend {args.backend} is not an MRF serving "
                         f"backend (int8)")
    if not args.artifact:
        raise SystemExit("--artifact is required: QAT training, which makes "
                         "artifacts, arrives with the training slice")
    if args.requests < 1:
        raise SystemExit("--requests must be >= 1")
    device = resolve_device(args.device)

    ints = qat.load_int8_artifact(args.artifact, device=device)
    in_dim = int(ints[0].w_q.shape[0])
    if in_dim != 2 * cfg.mrf_n_frames:
        raise SystemExit(f"artifact takes {in_dim} features; {cfg.name} has "
                         f"{cfg.mrf_n_frames} frames ({2 * cfg.mrf_n_frames})")
    impl = None if args.int8_impl == "auto" else args.int8_impl
    net_kw = dict(backend="int8", int_layers=ints, int8_impl=impl,
                  device=device)
    engine = ReconEngine(mode=args.serve_mode,
                         max_wave_voxels=args.max_wave_voxels,
                         max_wait_ms=args.max_wait_ms, **net_kw)
    print(f"int8 impl: {engine.int8_impl} (requested {args.int8_impl}) "
          f"on {device}")

    # request pool: one phantom slice per request, distinct noise draws
    seq = default_sequence(cfg.mrf_n_frames)
    t1_map, t2_map, mask = make_phantom(args.phantom_n)
    requests = []
    for i in range(args.requests):
        gen = torch.Generator(device=device).manual_seed(i)
        feats, msk = acquire_slice(seq, t1_map, t2_map, mask, generator=gen,
                                   device=device)
        requests.append(ReconRequest(features=feats, mask=msk,
                                     request_id=f"slice-{i}"))
    engines = [engine]

    engine.reconstruct(requests)  # warmup wave (builds and loads kernels)
    if args.serve_mode == "pipelined":
        # streaming admission: enqueue as slices "arrive", poll dispatches
        # due waves mid-stream, drain flushes the rest double-buffered
        tickets = []
        for r in requests:
            tickets.append(engine.enqueue(r))
            engine.poll()
        engine.drain()
        bad = [t for t in tickets if t.result is None]
        if bad:
            for t in bad:
                print(f"FAIL: request {t.request.request_id!r} "
                      f"{t.state}: {t.error}")
            return 1
        results = [t.result for t in tickets]
    else:
        results = engine.reconstruct(requests)
    wave = engine.last_wave
    pct = latency_percentiles(results)
    print(f"arch={cfg.name} backend=int8 mode={args.serve_mode} "
          f"requests={len(requests)} voxels={wave['total_voxels']} "
          f"waves={wave['n_waves']}")
    print(f"throughput: {wave['voxels_per_s']:.0f} voxels/s")
    print(f"latency: p50 {pct['p50_ms']:.3f} ms  p99 {pct['p99_ms']:.3f} ms")

    if args.serve_mode == "pipelined":
        # pipelining must be a pure scheduling change: same maps, bit-for-bit
        sync_engine = ReconEngine(**net_kw)
        engines.append(sync_engine)
        for got, want in zip(results, sync_engine.reconstruct(requests)):
            if not _maps_equal(got, want):
                print(f"FAIL: pipelined maps diverge from sync serving "
                      f"({got.request_id})")
                return 1
        print("pipelined == sync serving: bit-exact")
    # the network is untrained unless the artifact came from training:
    # tissue errors are informative, not gated
    for name, e in tissue_errors(results[0].t1_ms, results[0].t2_ms,
                                 t1_map, mask).items():
        print(f"  {name:6s}: T1 err {e['T1_err_%']:5.1f}%   "
              f"T2 err {e['T2_err_%']:5.1f}%")

    # the acceptance check: every served map == the plain integer oracle on
    # a CPU copy, bit for bit (the paper's FPGA-vs-Python criterion)
    ints_cpu = qat.load_int8_artifact(args.artifact, device="cpu")
    vox = np.asarray(mask, bool)
    for r, got in zip(requests, results):
        want = denormalize_targets(
            qat.int_forward(ints_cpu, r.features.cpu())).numpy()
        if not (np.array_equal(got.t1_ms[vox], want[:, 0])
                and np.array_equal(got.t2_ms[vox], want[:, 1])):
            print(f"FAIL: int8 engine diverges from qat.int_forward oracle "
                  f"({r.request_id})")
            return 1
    print(f"int8 engine == qat.int_forward oracle: bit-exact "
          f"({len(requests)} requests)")
    report = {"arch": cfg.name, "impl": engine.int8_impl,
              "mode": args.serve_mode, "device": str(device),
              "requests": len(requests), "voxels": wave["total_voxels"],
              "voxels_per_s": wave["voxels_per_s"], "wall_s": wave["wall_s"],
              "p50_ms": pct["p50_ms"], "p99_ms": pct["p99_ms"],
              "tiles": sum(e.executor.n_tiles_dispatched for e in engines)}
    print("serve_report " + json.dumps(report))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True,
                    help="mrf-fpga | mrf-original")
    ap.add_argument("--backend", default="int8",
                    help="int8 (full-integer CUDA kernels); float arrives "
                         "with the training slice")
    ap.add_argument("--int8-impl", default="auto",
                    choices=["auto", "fused", "layered", "lax"],
                    help="fused = whole-network CUDA kernel (auto), layered "
                         "= per-layer CUDA kernel chain, lax = plain "
                         "PyTorch; all bit-exact vs the qat.int_forward "
                         "oracle (checked)")
    ap.add_argument("--serve-mode", default="sync",
                    choices=["sync", "pipelined"],
                    help="sync = per-tile retirement baseline; pipelined = "
                         "double-buffered waves, one sync per wave "
                         "(bit-identical maps, checked)")
    ap.add_argument("--max-wave-voxels", type=int, default=None,
                    help="close a wave at this many voxels (default: one "
                         "wave per drain)")
    ap.add_argument("--max-wait-ms", type=float, default=None,
                    help="admission deadline from enqueue before a wave is "
                         "due (default: no deadline trigger)")
    ap.add_argument("--artifact", default=None,
                    help="the .npz int8 artifact to serve (required)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--phantom-n", type=int, default=32,
                    help="phantom slice side length")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    return serve_mrf(args, cfg)


if __name__ == "__main__":
    raise SystemExit(main())

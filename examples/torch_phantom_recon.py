"""The paper's end use-case on the port: reconstruct T1/T2 *maps* from MRF
signals as a client of the pipelined serving stack
(``repro_torch.serve.recon``).

Trains the adapted QAT net, exports it to the servable full-integer
artifact (save -> load round trip, the deployment unit), simulates the
phantom acquisition slice by slice, and *streams* each slice into the
engine's request queue as it is acquired — ``enqueue`` admits it (timing
starts here), ``poll`` dispatches waves already due, ``drain`` flushes the
rest through the double-buffered wave executor on the fused int8 kernel
B4.  Counterpart of ``examples/phantom_recon.py``.

Run:
    PYTHONPATH=src python examples/torch_phantom_recon.py
    PYTHONPATH=src python examples/torch_phantom_recon.py --device cpu

Exits 1 if any slice did not end ``done``.  The last line is
``phantom_report {json}``: the slices' states, the voxels, the waves and
the tiles each int8 implementation served.
"""

import argparse
import json
import tempfile

import torch

from repro_torch.core import qat
from repro_torch.core.train_loop import TrainConfig, train
from repro_torch.data.epg import default_sequence
from repro_torch.data.phantom import acquire_slice, make_phantom, tissue_errors
from repro_torch.kernels.common import disable_tf32, resolve_device
from repro_torch.serve.queue import RequestState
from repro_torch.serve.recon import ReconEngine, ReconRequest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=600,
                    help="QAT training steps (the reference's 600)")
    ap.add_argument("--slices", type=int, default=4)
    ap.add_argument("--phantom-n", type=int, default=32,
                    help="phantom slice side length")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        disable_tf32()

    print("=== train adapted QAT net (scaled schedule) ===")
    cfg = TrainConfig(n_frames=32, steps=args.train_steps, qat=True, lr=1e-3,
                      batch_size=256, log_every=200)
    params, qstate, _ = train(cfg, device=dev)

    print("\n=== export -> save -> load the servable int8 artifact ===")
    ints = qat.export_int8(params, qstate)
    with tempfile.TemporaryDirectory(prefix="mrf_artifact_") as tmp:
        path = qat.save_int8_artifact(f"{tmp}/mrf_int8", ints)
        served = qat.load_int8_artifact(path, device=dev)
        print(f"  artifact: {path.name}")

    print(f"\n=== stream {args.slices} phantom slices through the "
          f"pipelined int8 engine on {dev} ===")
    t1_map, t2_map, mask = make_phantom(args.phantom_n)
    seq = default_sequence(32)
    engine = ReconEngine(backend="int8", int_layers=served, mode="pipelined",
                         max_wave_voxels=1024, device=dev)

    def acquire(i):  # one slice per noise draw
        gen = torch.Generator(device=dev).manual_seed(i)
        return acquire_slice(seq, t1_map, t2_map, mask, snr=25.0,
                             generator=gen, device=dev)

    # warm-up: the buckets' first launches outside the streamed scan
    feats0, msk0 = acquire(0)
    engine.reconstruct([ReconRequest(features=feats0, mask=msk0)])

    tickets = []
    for i in range(args.slices):  # "acquisition", slice by slice
        feats, msk = acquire(i)
        tickets.append(engine.enqueue(
            ReconRequest(features=feats, mask=msk, request_id=f"slice-{i}")))
        engine.poll()  # dispatch any wave already due mid-scan
    engine.drain()
    wave = engine.last_wave
    # no voxels/s here: the session's wall time includes the acquisition's
    # simulation between enqueues; the per-slice latency is the serving one
    print(f"  {wave['total_voxels']} voxels served in {wave['n_waves']} "
          f"waves")
    for t in tickets:
        detail = (f"latency {t.latency_s * 1e3:6.1f} ms (from enqueue)"
                  if t.state == RequestState.DONE else t.error)
        print(f"  {t.request.request_id}: {t.state:9s} {detail}")
    done = [t for t in tickets if t.state == RequestState.DONE]
    report = {"slices": args.slices, "n_done": len(done),
              "states": [t.state for t in tickets],
              "voxels": wave["total_voxels"], "waves": wave["n_waves"],
              # tiles served by each int8 implementation, warm-up included
              "tiles_by_impl": dict(engine.executor.tiles_by_impl),
              "device": str(dev)}
    if done:
        result = done[0].result
        for name, e in tissue_errors(result.t1_ms, result.t2_ms, t1_map,
                                     mask).items():
            print(f"  {name:6s}: T1 err {e['T1_err_%']:5.1f}%   "
                  f"T2 err {e['T2_err_%']:5.1f}%")
        # coarse ASCII render of the T1 map (the paper's figure-style output)
        print("\nreconstructed T1 map (ms / 100):")
        for row in result.t1_ms[::2]:
            print("  " + "".join(f"{int(v / 100):2d}" if v > 50 else " ."
                                 for v in row[::2]))
    failed = len(done) != len(tickets)
    if failed:
        print("some slices failed; see states above")
    print("phantom_report " + json.dumps(report))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

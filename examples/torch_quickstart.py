"""Quickstart of the PyTorch port: the paper's pipeline end to end.

1. simulate MRF fingerprints (Bloch/EPG, SNR+phase augmentation)
2. train the FPGA-adapted net with QAT (the software reference path)
3. export the full-integer network and evaluate the paper's Table-1 metrics
4. run the SAME integer network through the int8 CUDA kernels — B4, the
   whole net in one launch (``fused``), and B5, one launch a layer
   (``layered``) — and check each bit for bit against the integer oracle
   ``core.qat.int_forward`` on a CPU copy (the paper's FPGA-vs-Python
   criterion)

Run (counterpart of ``examples/quickstart.py``):
    PYTHONPATH=src python examples/torch_quickstart.py            # on a card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the CPU the kernels' plain versions run.  Exits 1 unless both kernels
equal the oracle.
"""

import argparse
import dataclasses

import torch

from repro_torch.core import qat
from repro_torch.core.train_loop import TrainConfig, evaluate, train
from repro_torch.data.epg import default_sequence, simulate_fingerprints
from repro_torch.kernels.common import disable_tf32, resolve_device
from repro_torch.kernels.qat_dense.ops import (int_forward_fused,
                                               int_forward_layered,
                                               prepad_int_layers)


def _cpu_copy(int_layers) -> list:
    return [dataclasses.replace(layer, **{
        f: None if getattr(layer, f) is None else getattr(layer, f).cpu()
        for f in ("w_q", "b_q", "s_in", "s_w", "s_out")})
        for layer in int_layers]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300,
                    help="QAT training steps (the reference's 300)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        disable_tf32()

    print("=== 1. simulate fingerprints ===")
    seq = default_sequence(n_frames=32)
    sig = simulate_fingerprints(seq, [800.0, 1400.0, 300.0],  # ms: GM/WM/fat
                                [80.0, 110.0, 50.0], device=dev)
    print(f"fingerprints {tuple(sig.shape)} {sig.dtype}; |s|_2 = "
          f"{torch.linalg.vector_norm(sig, dim=-1).cpu().tolist()}")

    print("\n=== 2. QAT training (scaled schedule) ===")
    cfg = TrainConfig(n_frames=32, steps=args.steps, qat=True, lr=1e-3,
                      batch_size=256, log_every=100)
    params, qstate, info = train(cfg, device=dev)
    print(f"trained {info['sizes']} in {info['wall_seconds']:.1f}s on {dev}")

    print("\n=== 3. full-integer export + Table-1 metrics ===")
    ints = qat.export_int8(params, qstate)
    m = evaluate(params, seq, int_layers=ints, n=2000, device=dev)
    for p in ("T1", "T2"):
        print(f"  {p}: MAPE {m[p]['MAPE_%']:.2f}%  MPE {m[p]['MPE_%']:+.2f}%  "
              f"RMSE {m[p]['RMSE_ms']:.0f} ms")

    where = "" if dev.type == "cuda" else ": the kernels' plain versions"
    print(f"\n=== 4. int8 kernels bit-exactness (on {dev}{where}) ===")
    x = torch.randn((64, 64), generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    want = qat.int_forward(_cpu_copy(ints), x.cpu())
    net = prepad_int_layers(ints)
    same = {}
    for name, fn in (("B4 (fused kernel)", int_forward_fused),
                     ("B5 (layered kernel chain)", int_forward_layered)):
        same[name] = bool(torch.equal(fn(net, x).cpu(), want))
        print(f"  qat.int_forward == {name}: {same[name]}")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())

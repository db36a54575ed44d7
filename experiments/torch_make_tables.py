"""Print the port's dry-run tables — the per-cell proof of fit and the
roofline terms — from the records that ``python -m
repro_torch.launch.dryrun`` writes (``build/dryrun/*.json``), as
``experiments/make_tables.py`` prints the reference's.

Usage: PYTHONPATH=src python experiments/torch_make_tables.py
       [--label baseline] [--section dryrun|roofline|both] [--dir DIR]
Prints markdown to stdout.  The roofline terms are arithmetic on an H100
SXM's data-sheet peaks (``repro_torch.analysis.roofline.H100``), not
measurements.
"""

from __future__ import annotations

import argparse
import json
import pathlib

RECORDS = pathlib.Path(__file__).resolve().parents[1] / "build" / "dryrun"
CELL_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
              "long_500k": 3}
CARD_BYTES = 80e9  # an H100's memory


def records(directory: pathlib.Path, label: str, mesh: str) -> list:
    out = [json.loads(p.read_text())
           for p in sorted(directory.glob(f"*_{mesh}_{label}.json"))]
    out.sort(key=lambda r: (r["arch"], CELL_ORDER.get(r["shape"], 9)))
    return out


def human_bytes(b: float) -> str:
    if b >= 1e12:
        return f"{b / 1e12:.2f}TB"
    if b >= 1e9:
        return f"{b / 1e9:.2f}GB"
    return f"{b / 1e6:.1f}MB"


def fit_table(directory: pathlib.Path, label: str) -> None:
    print(f"\n### Dry-run — per-device cost, {label} (fake meshes: single "
          f"and multi)\n")
    print("| arch | shape | mesh | status | trace s | peak mem/dev | fits "
          "80 GB | collective bytes/dev | FLOP/dev | int8 FLOP/dev |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for mesh in ("single", "multi"):
        for r in records(directory, label, mesh):
            if r.get("status") != "ok":
                print(f"| {r['arch']} | {r['shape']} | {mesh} | ERROR: "
                      f"{r.get('error', '')[:60]} | | | | | | |")
                continue
            peak = r["memory"]["peak_per_device_bytes"]
            dims = "x".join(str(v) for v in r["mesh"].values())
            print(f"| {r['arch']} | {r['shape']} | {mesh} ({dims}) | ok | "
                  f"{r['trace_s']:.1f} | {human_bytes(peak)} | "
                  f"{'yes' if peak <= CARD_BYTES else 'no'} | "
                  f"{human_bytes(r['collectives'].get('total', 0))} | "
                  f"{r['flops']:.2e} | {r['flops_int8']:.2e} |")


def roofline_table(directory: pathlib.Path, label: str) -> None:
    print(f"\n### Roofline — per-cell terms on an H100 SXM (arithmetic, not "
          f"a measurement), {label}, single mesh\n")
    print("| arch | shape | compute s | memory s | collective s | dominant "
          "| roofline frac | MODEL_FLOPS/counted | next lever |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in records(directory, label, "single"):
        if r.get("status") != "ok":
            continue
        rf = r["roofline"]
        useful = rf.get("useful_flops_ratio") or 0.0
        print(f"| {r['arch']} | {r['shape']} | {rf['t_compute_s']:.4f} | "
              f"{rf['t_memory_s']:.4f} | {rf['t_collective_s']:.4f} | "
              f"{rf['dominant']} | {rf['roofline_fraction']:.3f} | "
              f"{useful:.2f} | {next_lever(r)} |")


def next_lever(r) -> str:
    """The lever the dominant term points at (the reference's rule of
    thumb, with the port's levers)."""
    dominant = r["roofline"]["dominant"]
    if dominant == "collective":
        return "--sp / --parallel-block / int8 gradients"
    if dominant == "compute":
        return "--quant int8-hlo"
    if r["kind"] == "decode":
        return "--serve-bf16 --serve-weights tp"
    return "fusion (eager bytes: every op's operands and results)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="baseline")
    ap.add_argument("--section", choices=["dryrun", "roofline", "both"],
                    default="both")
    ap.add_argument("--dir", default=str(RECORDS))
    args = ap.parse_args(argv)
    directory = pathlib.Path(args.dir)
    if args.section in ("dryrun", "both"):
        fit_table(directory, args.label)
    if args.section in ("roofline", "both"):
        roofline_table(directory, args.label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

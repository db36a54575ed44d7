"""The dry-run's counted FLOP of one training step at world 1 against
``chip_smoke.lm_step_work``'s analytic count, per LM family, on the CPU.

    PYTHONPATH=src python scripts/counter_vs_step_work.py

Each arch at full width, cut to a few layers so the trace takes seconds
(tinyllama whole at phase 4i's 8 x 2,048): ``launch.dryrun.trace_cell``
traces the train step under ``FakeTensorMode`` with no mesh and
``analysis.cost.StepCounter`` counts it; ``lm_step_work`` prices the same
step (products, B6 and B6-bwd, the SSD scan at f32).  One ``counter
{json}`` line per arch: both counts, their ratio and the counter's FLOP
by operator.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = (  # arch, layers (0: all), batch, tokens
    ("tinyllama-1.1b", 0, 8, 2048), ("granite-8b", 2, 2, 512),
    ("llava-next-34b", 1, 1, 3072), ("seamless-m4t-large-v2", 2, 2, 512),
    ("mamba2-1.3b", 2, 2, 512), ("hymba-1.5b", 2, 1, 512),
    ("deepseek-moe-16b", 2, 2, 512))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun

    for arch, layers, b, s in CASES:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
            if cfg.family == "encdec":
                cfg = dataclasses.replace(cfg, n_enc_layers=layers)
        rec = dryrun.trace_cell(cfg, ShapeCell("step", s, b, "train"))
        work = chip_smoke.lm_step_work(cfg, b, s)
        priced = work["flops"] + work["scan_flops"]
        print("counter " + json.dumps({
            "arch": arch, "layers": cfg.n_layers, "batch": b, "tokens": s,
            "counted": rec["flops"], "lm_step_work": priced,
            "ratio": rec["flops"] / priced,
            "flops_by_op": rec["flops_by_op"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 torch_bench/run.py --workload mrf-fpga.stream --seed 7 \\
        --seconds 10 --trace 0

from the checkout's root, on a machine with as many CUDA cards as the cell
asks for (``BENCHMARK.json``).  Set-up (imports, the kernel's build or
load, the job's first steps, a warm-up) counts into ``setup_s``; then the
window trains for about ``--seconds``; then the first steps are checked
against the plain reference.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``, each compared
number with its limit; the same numbers end standard error.  Exits 2 with
no result when there is no card or too few, 3 when JAX or the JAX package
was loaded.

Build and kernel caches stay inside the checkout (``build/``), checkpoints
in a directory of the run's own under ``TMPDIR``, removed at the end.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _settle_process() -> None:
    """One thread for host arithmetic (the host's cores are shared, and
    the run's host work is one Python thread staging batches).  Kernel and
    bytecode caches at fixed paths under ``build/``: only a checkout's
    first run builds.  A Python that writes no bytecode would compile
    torch's sources again in every run."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = ROOT / "build" / "torch_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    pycache = str(build / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = pycache
    sys.dont_write_bytecode, sys.pycache_prefix = False, pycache


def forbidden_loaded(modules) -> list:
    """The top-level names of ``modules`` (as ``sys.modules``) that are
    JAX's or the JAX package's, each compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - STARTED:9.3f} s] {msg}", file=sys.stderr,
          flush=True)


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            log=log, cell=None) -> dict:
    """One run of ``workload`` on ``device`` (no look for cards): the
    result line's object."""
    import torch

    from torch_bench.harness import spec

    cell = cell or spec.load_cell(workload)
    out = spec.harness(cell).run(cell, seed, seconds, trace, device, log,
                                 STARTED)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": out["peak"]}
    if trace:
        dev["busy_s"], dev["window_s"] = out["busy_s"], out["window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": dev}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in out["checks"]}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")
    _settle_process()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from torch_bench.harness import spec

    cell = spec.load_cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    log(f"torch imported, {cards} CUDA card(s)")
    if cards < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {cards} "
              f"here", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0), cell=cell)
    loaded = forbidden_loaded(sys.modules)
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

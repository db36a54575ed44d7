#!/usr/bin/env python3
"""The training path's spans on the card: the benchmark's own traced run
of a cell (``torch_bench/run.py --trace 1``), with the program's recorder
(``repro_torch.obs``) open inside the traced window, and closed, in turns.

    python3 scripts/torch_stream_spans.py --workload mrf-fpga.stream \\
        --seed 7 --seconds 10 --turns 2

``2 x --turns`` runs of ``run.main`` in this process, all on ``--seed``,
the recorder open in the first run of each turn and closed in the second
(open, closed, closed, open, ...).  The recording opens first thing inside
the window's annotation, where ``torch_bench/harness/spans.py`` expects
it; nothing else of the run changes.  After each run's own result line, a
``spans`` JSON line: the window's steps and ms a step on the trace's clock
and, with the recorder open, the four span numbers, the time by span, the
counters, and the offset of the recorder's clock to the trace's at the
window's start and end.  Last, a ``span_cost`` line: a span's cost with the
recorder closed (the null check) and open.  Needs a CUDA card.
"""

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def span_costs(obs, n: int = 200_000) -> dict:
    """ns a ``with obs.span(...)`` costs closed and open, less an empty
    loop's, median of 5."""
    def loop(body):
        t0 = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t0) / n

    def empty():
        for _ in range(n):
            pass

    def spans():
        for _ in range(n):
            with obs.span("repro_torch.cost"):
                pass

    def reps(body):
        return statistics.median(loop(body) for _ in range(5))

    base, closed = reps(empty), reps(spans)
    with obs.recording():
        opened = reps(spans)
    return {"closed_ns": closed - base, "open_ns": opened - base}


def recorded(traced, obs, on: bool, box: dict):
    """``traced`` with the recorder open (``on``) first thing inside the
    window; ``box`` gets the trace, the recording, the steps the window
    made and the recorder's clock at the window's edges."""
    def wrapped(fn, device):
        def window():
            box["in"], before = time.time_ns(), obs.counters()["steps"]
            if on:
                with obs.recording() as rec:
                    ret = fn()
                box["rec"] = rec
            else:
                ret = fn()
            box["out"] = time.time_ns()
            box["steps"] = obs.counters()["steps"] - before
            return ret

        ret, box["trace"] = traced(window, device)
        return ret, box["trace"]
    return wrapped


def spans_line(box: dict, spans) -> dict:
    tr, steps = box["trace"], box["steps"]
    rec = box.get("rec")
    start, end = (rec.opened_ns, rec.closed_ns) if rec else (box["in"],
                                                            box["out"])
    line = {"recorder": rec is not None, "steps": steps,
            "ms_per_step": tr.window_s * 1e3 / steps,
            "offset_start_ns": tr.window[0] - start,
            "offset_end_ns": tr.window[1] - end}
    if rec is not None:
        line["counters"] = rec.counters
        line.update({k: f(tr, rec) for k, f in spans.READERS.items()})
        line["by_span"] = spans.breakdown(tr, rec)
        line["spans_per_step"] = len(rec.spans) / steps
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="mrf-fpga.stream")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch import obs
    from torch_bench import run as bench_run
    from torch_bench.harness import spans
    from torch_bench.harness import trace as trace_mod

    traced = trace_mod.traced
    order = [True, False, False, True] * ((args.turns + 1) // 2)
    try:
        for on in order[:2 * args.turns]:
            box = {}
            trace_mod.traced = recorded(traced, obs, on, box)
            rc = bench_run.main(["--workload", args.workload, "--seed",
                                 str(args.seed), "--seconds",
                                 str(args.seconds), "--trace", "1"])
            if rc:
                return rc
            print("spans " + json.dumps(spans_line(box, spans)), flush=True)
    finally:
        trace_mod.traced = traced
    print("span_cost " + json.dumps(span_costs(obs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

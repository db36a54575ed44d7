"""A run of each cell driven on the CPU at a small size (the look for a
card skipped; the program's training kernel runs its plain version there):
the result line's keys, ``correct`` true, and ``correct`` false with the
timed path broken underneath (a state handed back unchanged, half of each
batch left out, a loss altered where it is produced).  The readings tool
with its control (the reference in TF32) and planted fault.  The trace's
arithmetic on synthetic records.  On a card, a short run of each cell
through ``run.py``."""

import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from torch_bench import readings, run  # noqa: E402
from torch_bench.harness import mrf_train, spec, trace  # noqa: E402
from torch_bench.yardstick import compare  # noqa: E402

# rows a step the CPU trains in well under a second
SMALL = {"mrf-fpga.stream": 32}
CPU = torch.device("cpu")


def small(cell: str):
    c = spec.load_cell(cell)
    return dataclasses.replace(
        c, traffic={**c.traffic, "samples_per_step": SMALL[cell]})


def drive(cell: str, seed: int = 2 ** 31 + 5) -> dict:
    return run.execute(cell, seed, 0.2, False, CPU, log=lambda m: None,
                       cell=small(cell))


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_run_is_correct_and_prints_the_keys(cell):
    out = drive(cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= spec.load_cell(cell).traffic["chunk_steps"]
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out["checks"]) == list(compare.COMPARED)
    assert out["device"]["count"] == 1
    json.dumps(out)


def _broken(real, how):
    """The program's K-step training call with ``how`` broken."""
    def call(params, opt_state, x, y, *, n_steps, **kw):
        if how == "half_batch":
            rows = x.shape[0] // n_steps
            keep = torch.arange(x.shape[0]) % rows < rows // 2
            return real(params, opt_state, x[keep], y[keep],
                        n_steps=n_steps, **kw)
        new_params, new_opt, losses = real(params, opt_state, x, y,
                                           n_steps=n_steps, **kw)
        if how == "unchanged":
            return params, opt_state, losses
        return new_params, new_opt, losses * 1.01  # "altered_loss"
    return call


@pytest.mark.parametrize("how", ["unchanged", "half_batch", "altered_loss"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_step_is_not_correct(cell, how, monkeypatch):
    from repro_torch.kernels.fused_train import ops
    monkeypatch.setattr(ops, "fused_train_multistep",
                        _broken(ops.fused_train_multistep, how))
    out = drive(cell)
    assert out["correct"] is False
    over = [k for k, c in out["checks"].items()
            if c["limit"] is not None and c["value"] > c["limit"]]
    assert over, out["checks"]


def test_the_readings_tool_gives_lower_and_upper_readings():
    lines = []
    # 256 rows a step: at 32, TF32's round-off moves a step's updates too
    # little to read against the cell's limit
    cell = dataclasses.replace(small("mrf-fpga.stream"), traffic={
        **small("mrf-fpga.stream").traffic, "samples_per_step": 256})
    summary = readings.readings(cell, [3, 4], 1, CPU, emit=lines.append)
    sides = [json.loads(s)["side"] for s in lines[:-1]]
    assert sides == ["program", "altered_loss", "tf32", "half_batch",
                     "program"]
    assert set(summary) == {"lower", "altered_loss", "tf32", "half_batch"}
    assert set(compare.COMPARED) <= set(summary["lower"])
    assert summary["half_batch"]["loss_gap"] > 10 * summary["lower"][
        "loss_gap"]
    assert summary["altered_loss"]["loss_gap"] == pytest.approx(0.01,
                                                                rel=0.05)
    # the control, the reference in TF32 in the program's place, comes out
    # not correct: through step_gap, by the cell's own limits
    limits = spec.load_cell("mrf-fpga.stream").limits
    tf32 = [json.loads(s) for s in lines[:-1]
            if json.loads(s)["side"] == "tf32"]
    assert tf32 and not compare.judge(tf32[0], limits)[0]
    assert tf32[0]["step_gap"] > limits["step_gap"]


def test_the_traced_run_adds_the_device_and_breakdown(monkeypatch):
    def fake(cell, seed, seconds, trace_on, device, log, started):
        return {"correct": True, "attempted": 4, "failed": 0,
                "metrics": {"device_idle_pct": {"value": 5.0, "unit": "%"}},
                "peak": 1024, "checks": [("loss_gap", 0.0, 1e-5)],
                "busy_s": 0.95, "window_s": 1.0,
                "breakdown": {"device_ops": [["k", 0.9]],
                              "idle_gaps": [["aten::cat", 0.05]]}}
    monkeypatch.setattr(mrf_train, "run", fake)
    out = run.execute("mrf-fpga.stream", 1, 1.0, True, CPU)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["device"]["busy_s"] == 0.95 and out["device"]["window_s"] == 1


def test_trace_arithmetic():
    ops = [("a", 10, 20), ("b", 15, 30), ("c", 50, 60)]
    host = [("aten::cat", 28, 55), ("aten::add", 30, 40)]
    tr = trace.Trace(ops, host, (0, 100))
    assert tr.busy_s == pytest.approx(30e-9)
    assert tr.window_s == pytest.approx(100e-9)
    assert trace._gaps(ops, (0, 100)) == [(0, 10), (30, 50), (60, 100)]
    assert tr.seconds(lambda n: n != "c") == (pytest.approx(25e-9), 2)
    assert tr.top_ops()[0] == ["b", pytest.approx(15e-9)]
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::cat"] == pytest.approx(20e-9)
    assert gaps["host Python, no op"] == pytest.approx(50e-9)


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    shutil.copytree(ROOT / "torch_bench", tmp_path / "torch_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run(
        [sys.executable, "torch_bench/run.py", "--workload",
         "mrf-fpga.stream", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_on_a_card_a_short_run_is_correct(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the training kernel has no CPU "
                    "mode")
    proc = subprocess.run(
        [sys.executable, "torch_bench/run.py", "--workload", cell,
         "--seed", "2147483700", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["busy_s"] > 0
    assert "breakdown" in out

"""The span arithmetic (``harness/spans.py``) on a synthetic trace and
recording with hand-counted overlaps, its ``None`` where a span count and
its counter differ, and on a real recording of the program's training
path on the CPU."""

import dataclasses
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from torch_bench.harness import spans, trace  # noqa: E402

OPENED = 5000  # the recorder's clock runs 5,000 ns ahead of the trace's
P = "repro_torch."


@dataclasses.dataclass
class Rec:
    spans: list
    counters: dict
    opened_ns: int = OPENED


def S(name, start, end, parent=-1, wait=False):
    from repro_torch.obs import Span
    return Span(P + name, start + OPENED, end + OPENED, parent, wait)


def synthetic(**counters):
    """One chunk of 4 steps staged in two batches, its launch, a retire
    and a checkpoint (the runner's drain, a forced retire; the manager's
    save, a host copy), in a 1,000 ns window."""
    rec = Rec([
        S("runner.dispatch", 100, 500),
        S("data.stage", 110, 300, 0),
        S("data.batch", 120, 200, 1),
        S("data.seq_tables", 130, 180, 2, wait=True),
        S("data.batch", 200, 280, 1),
        S("data.seq_tables", 210, 220, 4, wait=True),
        S("kernel.launch", 300, 320, 0),
        S("runner.retire", 520, 700, wait=True),
        S("runner.checkpoint", 700, 760),
        S("runner.retire", 700, 750, 8, wait=True),
        S("ckpt.save", 760, 900),
        S("ckpt.copy", 760, 800, 10, wait=True),
    ], {"steps": 4, "chunks": 1, "batches": 2, "ckpt_saves": 1,
        **counters})
    ops = [("fused_train_kernel", 0, 100), ("mul", 185, 195),
           ("fused_train_kernel", 320, 520), ("copy", 800, 850)]
    return trace.Trace(ops, [], (0, 1000)), rec


def test_each_number_reads_the_hand_counted_value():
    tr, rec = synthetic()
    assert spans.idle(tr) == [(100, 185), (195, 320), (520, 800),
                              (850, 1000)]
    # staging, less the two waits: 110-130, 180-210, 220-300
    assert spans.staging_host_ms_per_step(tr, rec) == pytest.approx(
        130e-6 / 4)
    # of it idle: all but the op at 185-195
    assert spans.staging_idle_pct(tr, rec) == pytest.approx(12.0)
    # outermost waits: 50 + 10 + 180 + 50 + 40
    assert spans.host_wait_ms_per_step(tr, rec) == pytest.approx(330e-6 / 4)
    # idle inside the drain and the save, 700-900: 700-800, 850-900
    assert spans.ckpt_stall_ms(tr, rec) == pytest.approx(150e-6)
    got = spans.breakdown(tr, rec)
    assert got["covered_pct"] == pytest.approx(78.0)
    assert got["idle_outside_spans_pct"] == pytest.approx(100 * 100 / 640)
    assert got["spans"]["data.seq_tables"]["count"] == 2
    assert got["spans"]["runner.retire"]["self_ms_per_step"] == \
        pytest.approx(230e-6 / 4)
    assert got["spans"]["kernel.launch"]["idle_s"] == pytest.approx(20e-9)


@pytest.mark.parametrize("counter, differs", [
    ("chunks", ["staging_host_ms_per_step", "staging_idle_pct",
                "host_wait_ms_per_step"]),
    ("batches", ["staging_host_ms_per_step", "staging_idle_pct"]),
    ("ckpt_saves", ["ckpt_stall_ms"])])
def test_a_span_count_other_than_its_counter_reads_nothing(counter, differs):
    tr, rec = synthetic()
    rec.counters[counter] += 1
    for name, read in spans.READERS.items():
        assert (read(tr, rec) is None) == (name in differs), name


def test_nothing_is_read_from_a_window_without_spans():
    tr, _ = synthetic()
    rec = Rec([], {"steps": 4, "chunks": 0, "batches": 0, "ckpt_saves": 0})
    assert all(read(tr, rec) is None for read in spans.READERS.values())


def test_innermost_labels_each_stretch_with_the_deepest_span():
    got = spans.innermost([("a", 0, 10, -1, False), ("b", 2, 5, 0, False),
                           ("c", 3, 4, 1, True), ("d", 12, 14, -1, False)])
    assert got == [(0, 2, 0), (2, 3, 1), (3, 4, 2), (4, 5, 1), (5, 10, 0),
                   (12, 14, 3)]


def test_a_real_recording_of_the_cpu_run_reads_every_number(tmp_path):
    """The program's own spans, on a window that is idle throughout (no
    device records): staging's idle share is its host time."""
    from repro_torch import obs
    from repro_torch.configs import get_smoke
    from repro_torch.ft.runner import RunnerConfig
    from repro_torch.models.mrf import build_mrf
    from repro_torch.train import engine

    fns = build_mrf(get_smoke("mrf-fpga"))
    ecfg = engine.EngineConfig(backend="fused", lr=1e-3, optimizer="sgd",
                               tile_batch=4, chunk_steps=4)
    with obs.recording() as rec:
        engine.train(fns, ecfg, RunnerConfig(
            total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=8),
            stream=engine.default_stream(fns.cfg, 16), seed=3,
            device=torch.device("cpu"))
    tr = trace.Trace([], [], (rec.opened_ns, rec.closed_ns))
    got = {name: read(tr, rec) for name, read in spans.READERS.items()}
    assert None not in got.values(), got
    window_ms = (rec.closed_ns - rec.opened_ns) / 1e6
    assert got["staging_idle_pct"] * window_ms / 100 == pytest.approx(
        got["staging_host_ms_per_step"] * rec.counters["steps"])
    assert spans.breakdown(tr, rec)["covered_pct"] > 50

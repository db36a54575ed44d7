"""The training path's spans and counters (``repro_torch.obs``) on the CPU,
the fused backend on its plain kernel: off unless a recording is open,
nested as the work is, counted as the counters count, and laid on a
profiler's trace by the offset at the window's annotation."""

import time

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_smoke
from repro_torch.ft import runner
from repro_torch.ft.runner import RunnerConfig
from repro_torch.models.mrf import build_mrf
from repro_torch.train import engine

CPU = torch.device("cpu")
BATCH = 16
WAITS = {"repro_torch.data.seq_tables", "repro_torch.runner.retire",
         "repro_torch.ckpt.wait", "repro_torch.ckpt.copy"}


@pytest.fixture(autouse=True)
def quiet_monitor(monkeypatch):
    """No eviction snapshot off the period on a loaded host."""
    class Quiet(runner.StragglerMonitor):
        def update(self, step_seconds, host=0):
            return None
    monkeypatch.setattr(runner, "StragglerMonitor", Quiet)


def _train(ckpt_dir, *, backend="fused", chunk_steps=4, total=12,
           ckpt_every=8, on_metrics=None):
    fns = build_mrf(get_smoke("mrf-fpga"))
    ecfg = engine.EngineConfig(backend=backend, lr=1e-3, optimizer="sgd",
                               tile_batch=4, chunk_steps=chunk_steps)
    rcfg = RunnerConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                        ckpt_every=ckpt_every)
    return engine.train(fns, ecfg, rcfg,
                        stream=engine.default_stream(fns.cfg, BATCH), seed=3,
                        on_metrics=on_metrics, device=CPU)


def _names(rec, name):
    return [s for s in rec.spans if s.name == f"repro_torch.{name}"]


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """3 chunks of 4 steps, a checkpoint at the second boundary (step 8);
    the run writes the step-0 checkpoint and resumes from it."""
    d = tmp_path_factory.mktemp("chunked")
    with obs.recording() as rec:
        state, step, _ = _train(d)
    return rec, state, step


def test_off_a_span_is_one_null_object_and_counters_still_count(tmp_path):
    assert obs.span("repro_torch.a") is obs.span("repro_torch.b", wait=True)
    before = obs.counters()
    _train(tmp_path, total=4, ckpt_every=4)
    after = obs.counters()
    assert obs._rec is None
    assert after["steps"] - before["steps"] == 4
    assert after["batches"] - before["batches"] == 4
    # the manager's save at step 4; the step-0 save is the runner's own
    assert after["ckpt_saves"] - before["ckpt_saves"] == 1
    with obs.recording() as rec:
        pass
    assert rec.spans == [] and set(rec.counters.values()) == {0}


def test_a_recording_does_not_nest():
    with obs.recording():
        with pytest.raises(RuntimeError):
            with obs.recording():
                pass
    assert obs._rec is None


def test_spans_nest_dispatch_stage_batch_seq_tables(chunked):
    rec, _, step = chunked
    assert step == 12
    spans = rec.spans
    assert all(isinstance(s, obs.Span) for s in spans)
    chain = ["runner.dispatch", "data.stage", "data.batch", "data.seq_tables"]
    for s in _names(rec, "data.seq_tables"):
        got, i = [s], s.parent
        while i >= 0:
            got.append(spans[i])
            i = spans[i].parent
        assert [g.name for g in reversed(got)] == [
            f"repro_torch.{c}" for c in chain]
        for inner, outer in zip(got, got[1:]):
            assert outer.start_ns <= inner.start_ns <= inner.end_ns \
                <= outer.end_ns
    launch = _names(rec, "kernel.launch")
    assert len(launch) == 3
    assert all(spans[s.parent].name == "repro_torch.runner.dispatch"
               for s in launch)
    # each chunk stages its 4 batches inside its own dispatch
    stages = [i for i, s in enumerate(spans)
              if s.name == "repro_torch.data.stage"]
    assert [sum(b.parent == i for b in _names(rec, "data.batch"))
            for i in stages] == [4, 4, 4]


def test_span_counts_equal_the_counters(chunked):
    rec, _, _ = chunked
    c = rec.counters
    assert c["steps"] == 12 and c["chunks"] == 3 and c["batches"] == 12
    assert len(_names(rec, "runner.dispatch")) == c["chunks"]
    assert len(_names(rec, "data.stage")) == c["chunks"]
    assert len(_names(rec, "data.batch")) == c["batches"]
    assert len(_names(rec, "data.seq_tables")) == c["batches"]
    assert len(_names(rec, "runner.retire")) == c["chunks"]
    # the step-8 boundary: the runner drains the chunk in flight, then the
    # manager saves; the step-0 save before the loop copies, unnamed
    assert len(_names(rec, "ckpt.save")) == c["ckpt_saves"] == 1
    (drain,) = _names(rec, "runner.checkpoint")
    (save,) = _names(rec, "ckpt.save")
    assert drain.end_ns <= save.start_ns
    assert [rec.spans[s.parent] for s in _names(rec, "runner.retire")
            if s.parent >= 0] == [drain]
    copies = _names(rec, "ckpt.copy")
    assert len(copies) == c["ckpt_saves"] + 1
    assert [rec.spans[s.parent] for s in copies if s.parent >= 0] == [save]
    assert len(_names(rec, "ckpt.restore")) == 1


def test_wait_flags_mark_exactly_the_four_wait_spans(chunked):
    rec, _, _ = chunked
    assert {s.name for s in rec.spans if s.wait} == WAITS
    assert not any(s.wait for s in rec.spans if s.name not in WAITS)
    assert _names(rec, "ckpt.wait")  # the step-8 save drained at the end


def test_a_stepwise_float_run_records_dispatch_and_batch_each_step(tmp_path):
    with obs.recording() as rec:
        _train(tmp_path, backend="float", chunk_steps=1, total=5,
               ckpt_every=4, on_metrics=lambda *a: None)
    assert len(_names(rec, "runner.dispatch")) == rec.counters["steps"] == 5
    assert len(_names(rec, "data.batch")) == rec.counters["batches"] == 5
    assert len(_names(rec, "runner.retire")) == 5
    assert rec.counters["chunks"] == 0
    # the step-4 save; a stepwise loop has no chunk in flight to drain
    assert len(_names(rec, "ckpt.save")) == rec.counters["ckpt_saves"] == 1
    assert not _names(rec, "runner.checkpoint")


def test_a_profiler_marker_inside_a_span_lies_inside_it_once_mapped():
    """The recorder's clock is moved onto the profiler's by the offset
    between a recording opened first thing inside the window's annotation
    and the annotation's start."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("torch_bench.window"):
            with obs.recording() as rec:
                with obs.span("repro_torch.outer"):
                    time.sleep(0.02)
                    with record_function("marker"):
                        torch.ones(8).add_(1)
                    time.sleep(0.02)
    evs = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() in ("torch_bench.window", "marker")}
    off = evs["torch_bench.window"][0] - rec.opened_ns
    (outer,) = rec.spans
    lo, hi = evs["marker"]
    assert outer.start_ns + off <= lo <= hi <= outer.end_ns + off
    assert abs(off) < 10_000_000  # both clocks are the Unix epoch's


def _mamba2_grads(tokens: int = 24):
    """The loss and gradients of mamba2's smoke model (2 layers, each
    block recomputed in the backward) on one batch."""
    from repro_torch.models import registry
    from repro_torch.tree import leaves, rebuild

    fns = registry.build(get_smoke("mamba2-1.3b"))
    params = fns.init(0, device=CPU)
    live = [t.requires_grad_(True) for t in leaves(params)]
    params = rebuild(params, live)
    toks = torch.arange(2 * tokens).reshape(2, tokens) % 256
    loss = fns.loss(params, {"tokens": toks, "labels": toks})
    return loss, live


def test_the_scan_is_a_span_a_call_and_its_backward_a_span_a_forward():
    """``model.ssd`` a call of the scan (the forward's and the recompute's:
    two a layer), as ``ssd_calls`` counts; ``model.ssd_bwd`` a forward
    made under grad (one a layer), as ``ssd_bwd_calls`` counts, each after
    its layer's recompute and in the backward's order of layers."""
    with obs.recording() as rec:
        loss, live = _mamba2_grads()
        torch.autograd.grad(loss, live)
    fwd, bwd = _names(rec, "model.ssd"), _names(rec, "model.ssd_bwd")
    assert len(fwd) == rec.counters["ssd_calls"] == 4
    assert len(bwd) == rec.counters["ssd_bwd_calls"] == 2
    assert None not in rec.spans
    recompute = sorted(fwd, key=lambda s: s.start_ns)[2:]
    for r, b in zip(recompute, sorted(bwd, key=lambda s: s.start_ns)):
        assert r.end_ns <= b.start_ns < b.end_ns


def test_a_scan_without_a_recording_or_under_no_grad_sets_no_hook():
    x = torch.ones(3, requires_grad=True)
    before = obs.counters()
    scan = obs.backward_span("repro_torch.model.ssd_bwd", x,
                             counter="ssd_bwd_calls")
    assert scan.inputs[0] is x  # no recording: the inputs themselves
    assert obs.counters()["ssd_bwd_calls"] == before["ssd_bwd_calls"] + 1
    with obs.recording() as rec, torch.no_grad():
        loss, _ = _mamba2_grads()
    assert rec.counters["ssd_calls"] == 2  # no recompute without grad
    assert rec.counters["ssd_bwd_calls"] == 0
    assert not _names(rec, "model.ssd_bwd")


def test_a_backward_on_another_thread_records_its_spans_there():
    """Autograd's device thread stands in: the backward runs on a thread
    of its own while the caller's span is open; its spans have no parent
    on the caller's thread and nest on their own."""
    import threading

    with obs.recording() as rec:
        loss, live = _mamba2_grads()
        with obs.span("repro_torch.caller", wait=True):
            t = threading.Thread(target=lambda: torch.autograd.grad(
                loss, live))
            t.start()
            t.join()
    (caller,) = _names(rec, "caller")
    bwd = _names(rec, "model.ssd_bwd")
    assert len(bwd) == 2 and all(s.parent == -1 for s in bwd)
    assert all(caller.start_ns < s.start_ns < s.end_ns < caller.end_ns
               for s in bwd)
    recompute = [s for s in _names(rec, "model.ssd")
                 if s.start_ns > caller.start_ns]
    assert len(recompute) == 2 and all(s.parent == -1 for s in recompute)

"""The LM cell's files on the CPU (``mamba2-1.3b.train``): the cell loads
with its harness and limits, the configuration is the program's mamba2 at
its published widths, the two copies of the plain reference are one file,
the frozen token stream, initial weights and work count are the port's,
the reference's Adam is the port's; the readers read nothing without
spans or where a span count differs from its counter, and read the
hand-counted values of a synthetic trace; the cell driven at the smoke
size gives ``correct`` true, and false with the program broken underneath
(the scan in bf16, the inter-chunk term or D dropped, half of each batch,
another init, a state left unchanged after step 1, the moments lost on
resume, each loss altered by 1%)."""

import dataclasses
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from torch_bench import run  # noqa: E402
from torch_bench.harness import lm_trace, lm_train, spec  # noqa: E402
from torch_bench.yardstick import (lm_compare, lm_data, lm_init,  # noqa: E402
                                   lm_work)

CELL = "mamba2-1.3b.train"
METRICS = ("ssd_scan_ms_per_step", "ssd_scan_roofline", "lm_train_mfu_pct")
CPU = torch.device("cpu")
OPENED = 5000  # the recorder's clock runs 5,000 ns ahead of the trace's


def small(batch: int = 2, seq: int = 32):
    """The cell at the smoke size: two layers of mamba2's smoke model, its
    head tied as the cell states."""
    c = spec.load_cell(CELL)
    config = {**c.config, "smoke": True, "n_layers": 2, "d_model": 64,
              "d_inner": 128, "n_heads": 8, "head_dim": 16, "d_state": 8,
              "chunk_size": 8, "vocab_rows": 256}
    return dataclasses.replace(c, config=config, traffic={
        **c.traffic, "batch": batch, "seq": seq})


def drive(cell=None, seed: int = 2 ** 31 + 5) -> dict:
    return run.execute(CELL, seed, 0.2, False, CPU, log=lambda m: None,
                       cell=cell or small())


def test_the_cell_loads_with_its_harness_and_limits():
    c = spec.load_cell(CELL)
    assert spec.harness(c) is lm_train and c.chips == 1
    assert set(c.limits) >= set(lm_compare.COMPARED) | {"compared_steps"}
    assert c.limits["count_gap"] == 0 and c.limits["compared_steps"] >= 2
    assert [m["name"] for m in c.end_to_end] == ["train_samples_per_s",
                                                 "setup_s"]
    assert [m["name"] for m in c.per_layer] == list(METRICS)
    t = c.traffic
    assert (t["kind"], t["batch"], t["seq"], t["optimizer"]) == (
        "train", 8, 2048, "adam")
    # no checkpoint in the window: the compared steps, a warm-up step and
    # a ~10 s window of ~1.7 s steps stay short of the period
    assert t["ckpt_every"] > c.limits["compared_steps"] + 1 + 10


def test_the_configuration_is_the_programs_mamba2_at_its_widths():
    c = spec.load_cell(CELL).config
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(x for x in bench["configs"] if x["name"] == c["name"])
    assert entry["source"] == c["source"] and entry["reduced"] == list(
        c["reduced"]) == ["n_layers"]
    assert (c["n_layers"], c["published"]["n_layers"]) == (24, 48)
    cfg = lm_train.model_config(c)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_ssm_heads,
            cfg.ssm_state, cfg.ssm_chunk, cfg.vocab_size) == (
        24, 2048, 4096, 64, 128, 256, 50280)
    assert cfg.tie_embeddings and c["vocab_size"] == 50277
    assert c["d_inner"] == c["expand"] * c["d_model"] == c["n_heads"] * c[
        "head_dim"]
    with pytest.raises(ValueError, match="states"):
        lm_train.model_config({**c, "d_state": 64})


def test_the_two_copies_of_the_reference_are_one_file():
    bench = (ROOT / "torch_bench" / "yardstick" / "mamba2_ref.py").read_text()
    tests = (ROOT / "tests" / "plain" / "mamba2.py").read_text()
    assert bench == tests


def test_the_frozen_token_stream_is_the_ports():
    from repro_torch.data.lm_text import TextPipeline
    for seed, step in ((0, 0), (2 ** 31 - 1, 5), (123456, 2 ** 32 - 1)):
        want = TextPipeline(seq_len=64, batch_size=3, seed=seed).batch_at(
            step)
        toks, labs = lm_data.batch(seed, step, 3, 64)
        assert torch.equal(toks, torch.from_numpy(want["tokens"]).long())
        assert torch.equal(labs, torch.from_numpy(want["labels"]).long())


def test_the_frozen_work_is_the_ports():
    from repro_torch.analysis.roofline import ssd_flops
    c = spec.load_cell(CELL).config
    cfg = lm_train.model_config(c)
    assert lm_work.ssd_flops(c, 8, 2048) == ssd_flops(cfg, 8, 2048)
    assert lm_work.ssd_flops(c, 3, 300) == ssd_flops(cfg, 3, 300)
    # the per-layer parameters the port counts (less the conv taps)
    from repro_torch.configs.base import param_count
    assert c["n_layers"] * lm_work.layer_params(c) + c["d_model"] * (
        c["vocab_rows"] + 1) == param_count(cfg)
    assert lm_work.scan_least_seconds(c, 8, 2048) == pytest.approx(
        3 * 1.2515e12 / 67e12, rel=1e-3)  # compute binds


@dataclasses.dataclass
class Rec:
    spans: list
    counters: dict
    opened_ns: int = OPENED


def synthetic(**counters):
    """Two steps' scan: a forward span and a backward span a step, in a
    1,000 ns window; device ops launched inside and outside them."""
    from repro_torch.obs import Span
    p = "repro_torch.model."

    def S(name, start, end):
        return Span(p + name, start + OPENED, end + OPENED, -1, False)

    rec = Rec([S("ssd", 100, 200), S("ssd_bwd", 300, 400),
               S("ssd", 500, 600), S("ssd_bwd", 700, 800)],
              {"steps": 2, "ssd_calls": 2, "ssd_bwd_calls": 2, **counters})
    ops = [("mul", 150, 180), ("mm", 210, 260), ("exp", 420, 470),
           ("bmm", 610, 640), ("mul", 820, 850), ("copy", 900, 950)]
    launched = [120, 205, 350, 590, 790, None]
    return lm_trace.LaunchTrace(ops, [], (0, 1000), launched), rec


def ctx_of(tr, rec, samples=16, window_s=2.0):
    return lm_train.ReadContext(trace=tr, rec=rec, samples=samples,
                                window_s=window_s,
                                model=spec.load_cell(CELL).config,
                                batch=8, seq=2048)


def test_the_readers_read_the_hand_counted_values():
    tr, rec = synthetic()
    # launched inside the spans: mul (30), exp (50), bmm (30), mul (30)
    assert lm_trace.scan_ops(tr, rec) == [0, 2, 3, 4]
    ms = lm_trace.scan_ms_per_step(tr, rec)
    assert ms == pytest.approx(140e-6 / 2)
    ctx = ctx_of(tr, rec)
    assert spec.reader("ssd_scan_ms_per_step")(ctx) == pytest.approx(ms)
    least = lm_work.scan_least_seconds(ctx.model, 8, 2048)
    assert spec.reader("ssd_scan_roofline")(ctx) == pytest.approx(
        100 * least / (ms / 1e3))
    mfu = spec.reader("lm_train_mfu_pct")(ctx)
    assert mfu == pytest.approx(100 * 2 * lm_work.model_flops(
        ctx.model, 8, 2048) / (2.0 * 989e12))
    got = lm_trace.breakdown(tr, rec)
    assert got["scan_op_count"] == 4 and got["scan_ops"][0][0] == "mul"
    assert got["launch_linked_pct"] == pytest.approx(100 * 5 / 6)


@pytest.mark.parametrize("counter", ["ssd_calls", "ssd_bwd_calls"])
def test_a_span_count_other_than_its_counter_reads_nothing(counter):
    tr, rec = synthetic(**{counter: 3})
    for name in METRICS[:2]:
        assert spec.reader(name)(ctx_of(tr, rec)) is None


def test_nothing_is_read_without_spans_or_a_trace():
    tr, rec = synthetic()
    empty = Rec([], dict(rec.counters, ssd_calls=0, ssd_bwd_calls=0))
    for name in METRICS[:2]:
        assert spec.reader(name)(ctx_of(tr, empty)) is None
        assert spec.reader(name)(ctx_of(tr, None)) is None
        assert spec.reader(name)(ctx_of(None, rec)) is None
    assert spec.reader("lm_train_mfu_pct")(ctx_of(None, None, 0)) is None


def test_a_real_recording_of_the_cpu_step_has_one_span_a_counted_call(
        tmp_path):
    """The program's own spans over two smoke steps on the CPU: a forward
    and a recompute span a layer and step, a backward span a layer and
    step, as the counters count; device ops launched in each span are
    the scan's."""
    from repro_torch import obs
    job = lm_train.Job(small(), 7, CPU, str(tmp_path / "ckpt"))
    with obs.recording() as rec:
        job.train(2, 0)
    c, n = rec.counters, job.cfg.n_layers * 2
    assert (c["steps"], c["ssd_calls"], c["ssd_bwd_calls"]) == (2, 2 * n, n)
    window = (rec.opened_ns, rec.closed_ns)
    spans = [s for s in rec.spans if s.name.startswith(lm_trace.SCAN)]
    ops = [("k", s.start_ns, s.end_ns) for s in spans]
    tr = lm_trace.LaunchTrace(ops, [], window,
                              [s.start_ns + 1 for s in spans])
    assert lm_trace.scan_ops(tr, rec) == list(range(len(spans)))
    assert lm_trace.scan_ms_per_step(tr, rec) > 0


def test_a_run_is_correct_and_prints_the_keys():
    out = drive()
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["attempted"] >= 2
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert list(out["checks"]) == list(lm_compare.COMPARED)
    json.dumps(out)


def _altered(real):
    def job(*args, **kw):
        out = real(*args, **kw)
        return out._replace(losses={k: v * 1.01
                                    for k, v in out.losses.items()})
    return job


@pytest.mark.parametrize("fault", [*lm_train.FAULTS, "altered_loss"])
def test_a_broken_program_is_not_correct(fault, monkeypatch):
    if fault == "altered_loss":
        from repro_torch.launch import train as launcher
        monkeypatch.setattr(launcher, "lm_job", _altered(launcher.lm_job))
        out = drive()
    else:
        with lm_train.planted(fault):
            out = drive()
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_readings_tool_plants_each_fault():
    from torch_bench import readings
    lines = []
    summary = readings.readings(small(), [3], 1, CPU, emit=lines.append)
    sides = [json.loads(s)["side"] for s in lines[:-1]]
    assert sides == ["program", "altered_loss", *lm_train.FAULTS]
    assert summary["altered_loss"]["loss_gap"] == pytest.approx(0.01,
                                                                rel=0.05)
    assert summary["half_batch"]["loss_gap"] > 10 * summary["lower"][
        "loss_gap"]


def test_the_harness_path_trains_the_tied_head_as_one_leaf(tmp_path):
    """The program's state on the harness path holds the embedding and no
    head; step 1 moves the embedding by the sign of the reference's
    gradient of its two uses, not of the lookup's alone."""
    from torch_bench.yardstick import mamba2_ref

    job = lm_train.Job(small(), 9, CPU, str(tmp_path / "ckpt"))
    side = lm_train.checked_steps(job, 1)
    assert "head" not in side["ends"][0]
    tied = lm_init.init_params(job.config, job.init_seed, CPU)
    assert "head" not in tied
    tokens, labels = lm_data.batch(job.data_seed, 0, job.batch, job.seq)
    _, both = mamba2_ref.loss_and_grads(tied, tokens, labels)
    _, apart = mamba2_ref.loss_and_grads(
        {**tied, "head": tied["embed"].t().clone()}, tokens, labels)
    moved = side["ends"][0]["embed"] - tied["embed"]
    # measured at seeds 9-11: 9.4e-6-5.8e-5 against the sum, 0.052-0.061
    # against the lookup's use, 0.18-0.23 against the head's
    assert lm_compare.sign_share(moved, both["embed"]) < 1e-3
    assert lm_compare.sign_share(moved, apart["embed"]) > 0.02
    assert lm_compare.sign_share(moved, apart["head"].t()) > 0.1


@pytest.mark.parametrize("tied", [True, False])
def test_the_frozen_init_is_the_ports(tied):
    """The reference's initial weights are the port's, bit for bit: the
    smoke widths tied and untied, and one layer at the cell's widths."""
    from repro_torch.models import registry
    c = {**small().config, "tie_embeddings": tied}
    full = {**spec.load_cell(CELL).config, "n_layers": 1}
    for config, seed in ((c, 0), (c, 2 ** 31 - 1), (full, 123457)):
        cfg = lm_train.model_config(config)
        port = lm_train._plain(registry.build(cfg).init(seed, device=CPU),
                               CPU)
        ours = lm_init.init_params(config, seed, CPU)
        got, want = lm_train._leaves(ours), lm_train._leaves(port)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, a), (_, b) in zip(got, want, strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if config is full:
            break


def test_the_scan_is_taken_as_the_program_ran_it(tmp_path):
    """The first scan of a call, taken on its first sequence, is the
    program's: the reference agrees with it to float32 round-off, and
    the scan planted in bf16 reads a thousandfold more."""
    from torch_bench.yardstick import mamba2_ref
    gaps = {}
    for fault in ("program", "scan_bf16"):
        job = lm_train.Job(small(), 4, CPU, str(tmp_path / fault))
        with lm_train.planted(fault), lm_train.scan_taken() as got:
            job.train(1, 0)
        x, dt, A, B, C = got["inputs"]
        assert x.shape == (job.seq, 8, 16) and B.shape == (job.seq, 8)
        assert got["y"].shape == x.shape and got["y"].dtype == torch.float32
        gaps[fault] = lm_compare.scan_gap(got["y"],
                                          mamba2_ref.ssm(*got["inputs"]))
    assert gaps["program"] < 1e-6 and gaps["scan_bf16"] > 1e3 * gaps[
        "program"]


def test_the_references_adam_is_the_ports():
    """Three steps of the reference's Adam (float64) against the port's
    (float32) on random leaves, the moments carried as the port hands them
    back; an unchanged leaf reads an update gap of 1, a reversed one 2."""
    from repro_torch.optim import adam
    gen = torch.Generator().manual_seed(3)
    p = {"a": torch.randn(4096, generator=gen)}
    opt = adam(3e-4)
    state = opt.init(p)
    for step in (1, 2, 3):
        g = {"a": torch.randn(4096, generator=gen)}
        new, after = opt.update(g, state, p)
        want, m = lm_compare.adam_update(g["a"], state.mu["a"], state.nu["a"],
                                         step, 3e-4)
        got = new["a"] - p["a"]
        part, whole = lm_compare.update_counts(got, want, m)
        assert part / whole < 1e-4
        # float32 round-off of b1 m + (1 - b1) g, where the two cancel
        assert torch.allclose(m.float(), after.mu["a"], rtol=1e-6,
                              atol=1e-7)
        zero, whole = lm_compare.update_counts(torch.zeros_like(got), want, m)
        assert zero / whole == pytest.approx(1.0)
        back, whole = lm_compare.update_counts(-want, want, m)
        assert back / whole == pytest.approx(2.0)
        p, state = new, after

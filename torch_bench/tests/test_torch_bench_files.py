"""The benchmark's files on the CPU: every cell, configuration and metric
of ``BENCHMARK.json`` loads from its files, the files keep to the
benchmark's contract, nothing under ``torch_bench/`` imports JAX or the
JAX package (and the yardstick nothing of the port), and the frozen data
stream and init draw what the port draws, bit for bit."""

import ast
import json
import pathlib
import re
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "torch_bench"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from torch_bench.harness import mrf_train, spec  # noqa: E402
from torch_bench.yardstick import mrf_data  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["torch_bench"]
    assert SPEC["command"][1].startswith("torch_bench/")
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("torch_bench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert {"setup_s", "train_samples_per_s"} <= set(e2e)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_from_its_files(cell):
    c = spec.load_cell(cell)
    assert c.config["widths"][0] == 2 * c.config["n_frames"]
    from torch_bench.yardstick import compare

    assert set(c.limits) >= set(compare.COMPARED) | {"single_steps"}
    assert c.limits["count_gap"] == 0
    assert spec.harness(c).run
    segs = mrf_train.segments(c)
    assert segs[:2] == [1, c.traffic["chunk_steps"]]
    assert segs.count(1) == c.limits["single_steps"]
    assert c.traffic["samples_per_step"] % c.traffic["tile"] == 0
    assert [m["name"] for m in c.end_to_end] == [
        "train_samples_per_s", "setup_s"]
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    ctx = mrf_train.ReadContext(trace=None, samples=0, launches=0,
                                window_s=0.0, widths=(64, 2), tile=1,
                                optimizer="sgd")
    assert spec.reader(metric)(ctx) is None


# every configuration file, also those no cell runs yet
CONFIG_FILES = sorted((BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_configurations_are_the_programs_nets(path):
    from repro_torch.configs import get_config
    from repro_torch.core.mrf_net import layer_sizes

    c = json.loads(path.read_text())
    assert c["name"] == path.stem
    cfg = get_config(c["program_arch"])
    assert tuple(layer_sizes(cfg.mrf_n_frames, cfg.mrf_hidden)) == tuple(
        c["widths"])
    assert c["widths"][0] == 2 * c["n_frames"]
    for config in SPEC["configs"]:
        if config["file"] == str(path.relative_to(ROOT)):
            assert c["source"] == config["source"]
            assert config["reduced"] == []


def _top_level_imports(path: pathlib.Path) -> set:
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    return found


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = _top_level_imports(f) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
    for f in sorted((BENCH / "yardstick").glob("*.py")):
        assert "repro_torch" not in _top_level_imports(f), f
    # compared whole: the port's name begins with the JAX package's
    from torch_bench.run import forbidden_loaded
    assert forbidden_loaded(["repro_torch", "repro_torch.train", "numpy"]) \
        == []
    assert forbidden_loaded(["repro.models", "jaxlib.xla", "torch"]) == [
        "jaxlib", "repro"]


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_frozen_stream_and_init_draw_what_the_port_draws(path):
    from repro_torch.configs import get_config
    from repro_torch.data.epg import default_sequence
    from repro_torch.data.pipeline import MRFSampleStream, batch_at
    from repro_torch.models import registry

    c = json.loads(path.read_text())
    st = mrf_data.stream_of(c, 96)
    seq = default_sequence(c["n_frames"])
    assert st.flip_angles == seq.flip_angles and st.trs == seq.trs
    port = MRFSampleStream(seq=seq, batch_size=96)
    cpu = torch.device("cpu")
    for seed, step in ((0, 0), (2 ** 31 - 1, 5), (123456, 2 ** 32 - 1)):
        x, y = mrf_data.batch(st, seed, step, cpu)
        b = batch_at(port, seed, step, device=cpu)
        assert torch.equal(x, b["x"]) and torch.equal(y, b["y"])
    fns = registry.build(get_config(c["program_arch"]))
    ours = mrf_data.init_params(c["widths"], 77, cpu)
    theirs = fns.init(torch.Generator(device=cpu).manual_seed(77))
    for (w, b), layer in zip(ours, theirs, strict=True):
        assert torch.equal(w, layer["w"]) and torch.equal(b, layer["b"])


def test_seeds_cover_large_ones():
    a = mrf_train.seeds_of(2 ** 31 + 12345)
    assert a == mrf_train.seeds_of(2 ** 31 + 12345)
    assert 0 <= a[0] < 2 ** 31 and a != mrf_train.seeds_of(12345)

"""A cell as ``BENCHMARK.json`` names it, and the files found by those
names: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json``, the harness ``harness/<family>_<kind>.py`` (the
configuration's ``family``, the traffic's ``kind``) and
``metrics/<metric>.py``."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple   # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    spec = benchmark(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in spec['workloads']]}")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    bench = root / BENCH.name
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_json(root / config["file"]),
        traffic=_json(bench / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(bench / "limits" / f"{name}.json"),
        end_to_end=tuple(m for m in spec["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in spec["per_layer"] if _reports(m, name)))


def harness(cell: Cell):
    """The module ``harness/<family>_<kind>.py`` that drives ``cell``: its
    ``run(cell, seed, seconds, trace, device, log, started)`` gives the
    result's fields, per-layer metrics read with a context of its own."""
    name = f"{cell.config['family']}_{cell.traffic['kind']}"
    if not (BENCH / "harness" / f"{name}.py").is_file():
        raise FileNotFoundError(f"{cell.name}: no harness "
                                f"{BENCH.name}/harness/{name}.py")
    return importlib.import_module(f"{BENCH.name}.harness.{name}")


def reader(metric: str, root: pathlib.Path = ROOT):
    """The ``read(ctx) -> float | None`` of ``metrics/<metric>.py``."""
    path = root / BENCH.name / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(
        f"torch_bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

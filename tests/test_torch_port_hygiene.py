"""Structural guarantees of the PyTorch port (``src/repro_torch``).

* The port imports neither JAX nor the JAX package — nor do its examples
  (``examples/torch_*.py``) or ``chip_smoke.py``.
* Every CUDA source that kernels.build names exists, every header is
  included by a source (and so keys its build), and the flags keep IEEE
  arithmetic (no fast math) for ``sm_90a``.
* Devices are explicit: asking for CUDA without a card raises instead of
  falling back to the CPU.
* The port's identifiers stay clear of ``scripts/dead_exports_allowlist.txt``,
  whose gate counts an identifier anywhere under ``src/`` or ``tests/`` as
  a use of the JAX symbol of that name.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import qat
from repro_torch.data.epg import default_sequence, simulate_fingerprints
from repro_torch.kernels import build
from repro_torch.kernels.common import (INT8_IMPL_CHOICES, resolve_device,
                                        resolve_int8_impl)
from repro_torch.kernels.flash_attn.kernel import (flash_attention_bwd_call,
                                                   flash_attention_call)
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.qat_dense.kernel import qat_dense_call
from repro_torch.launch import serve as launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import registry
from repro_torch.serve.executor import WaveExecutor
from repro_torch.serve.recon import ReconEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _examples():
    return sorted((ROOT / "examples").glob("torch_*.py"))


def _port_files():
    return (sorted(PORT.rglob("*.py")) + _examples()
            + [ROOT / "chip_smoke.py"])


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and len(_examples()) == 5
    # the sharding slice's modules are among them
    assert {PORT / "dist" / "sharding.py", PORT / "dist" / "__init__.py",
            PORT / "launch" / "mesh.py", PORT / "launch" / "input_specs.py",
            PORT / "ft" / "elastic.py"} <= set(files)
    files = files + [ROOT / "tests" / "_torch_dist_worker.py"]
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files
           for line, mod in _imported_roots(ast.parse(f.read_text()))
           if mod in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_kernel_sources_exist_and_build_flags_are_exact():
    named = {build.CSRC / src for src in build.SOURCES.values()}
    assert all(p.is_file() for p in named)
    assert set(build.CSRC.glob("*.cu")) == named
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    for src in named:
        text = src.read_text()
        # B6-bwd has no TPU counterpart: it says so, and names what the
        # reference differentiates instead
        assert ("Replaces no TPU kernel" if src.name == "flash_attn_bwd.cu"
                else "Replaces: src/repro/kernels/") in text
        assert "roundf(" not in text.replace("rintf(", "")
    # each source names the TPU kernel files it replaces, and they exist
    replaces = {
        "fused_forward.cu": ["src/repro/kernels/qat_dense/fused.py"],
        "qat_dense.cu": ["src/repro/kernels/qat_dense/kernel.py"],
        "fused_train.cu": ["src/repro/kernels/fused_train/kernel.py",
                           "src/repro/kernels/fused_train/multistep.py"],
        "flash_attn.cu": ["src/repro/kernels/flash_attn/kernel.py"],
        "flash_attn_sm90.cu": ["src/repro/kernels/flash_attn/kernel.py"],
        "flash_attn_bwd.cu": ["src/repro/models/attention.py",
                              "src/repro/kernels/flash_attn/kernel.py"],
    }
    assert set(replaces) == {p.name for p in named}
    for name, tpu_files in replaces.items():
        text = (build.CSRC / name).read_text()
        for tpu_file in tpu_files:
            assert tpu_file in text and (ROOT / tpu_file).is_file()
    # every header is included by some source, so it enters that source's
    # build key (build.library_path)
    headers = set(build.CSRC.glob("*.cuh"))
    included = {h for src in build.SOURCES.values()
                for h in build.included_headers(src)}
    assert headers == included
    for h in headers:
        assert "roundf(" not in h.read_text().replace("rintf(", "")


def test_library_path_keys_on_included_headers(tmp_path, monkeypatch):
    """Editing a header a source includes (directly or through another
    header) moves the library to a new path, so no stale build is reused;
    editing a header nobody includes does not."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b = 1;\n")
    (tmp_path / "c.cuh").write_text("int c = 1;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {"k": "k.cu"})
    assert build.included_headers("k.cu") == [tmp_path / "a.cuh",
                                              tmp_path / "b.cuh"]
    first = build.library_path("k")
    (tmp_path / "c.cuh").write_text("int c = 2;\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("int b = 2;\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// x\n')
    assert build.library_path("k") not in (first, second)


def test_int8_impl_resolution_has_no_rig_fallback():
    assert resolve_int8_impl(None) == "fused"
    for impl in INT8_IMPL_CHOICES:
        assert resolve_int8_impl(impl) == impl
    with pytest.raises(ValueError):
        resolve_int8_impl("pallas")


def _net():
    g = torch.Generator().manual_seed(0)
    from repro_torch.core import mrf_net
    params = mrf_net.init_params(g, mrf_net.layer_sizes(32))
    return params, qat.export_int8(
        params, qat.init_qat_state(len(params), device="cpu"))


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    params, ints = _net()
    path = qat.save_int8_artifact(tmp_path / "net", ints)
    lm_fns = registry.build(get_smoke("tinyllama-1.1b"))
    moe_fns = registry.build(get_smoke("deepseek-moe-16b"))
    ssm_fns = registry.build(get_smoke("mamba2-1.3b"))
    hybrid_fns = registry.build(get_smoke("hymba-1.5b"))
    encdec_fns = registry.build(get_smoke("seamless-m4t-large-v2"))
    vlm_fns = registry.build(get_smoke("llava-next-34b"))
    calls = [
        lambda: resolve_device("cuda"),
        lambda: qat.init_qat_state(3),
        lambda: qat.load_int8_artifact(path),
        lambda: simulate_fingerprints(default_sequence(8), [800.0], [80.0]),
        lambda: WaveExecutor(backend="int8", int_layers=ints),
        lambda: ReconEngine(backend="float", params=params),
        lambda: launcher.main(["--arch", "mrf-fpga", "--artifact", str(path)]),
        lambda: lm_fns.init(0),
        lambda: lm_fns.init_cache(1, 8),
        lambda: lm_params_from_numpy({}),
        lambda: launcher.main(["--arch", "tinyllama-1.1b", "--smoke"]),
        lambda: moe_fns.init(0),
        lambda: launcher.main(["--arch", "deepseek-moe-16b", "--smoke"]),
        lambda: ssm_fns.init(0),
        lambda: ssm_fns.init_cache(1, 8),
        lambda: hybrid_fns.init_cache(1, 8),
        lambda: launcher.main(["--arch", "mamba2-1.3b", "--smoke"]),
        lambda: launcher.main(["--arch", "hymba-1.5b", "--smoke"]),
        lambda: encdec_fns.init(0),
        lambda: encdec_fns.init_cache(1, 8),
        lambda: vlm_fns.init(0),
        lambda: launcher.main(["--arch", "seamless-m4t-large-v2",
                               "--smoke"]),
        lambda: launcher.main(["--arch", "llava-next-34b", "--smoke",
                               "--prompt-len", "16"]),
        lambda: train_launcher.main(["--arch", "tinyllama-1.1b", "--smoke"]),
        lambda: train_launcher.main(["--arch", "llava-next-34b", "--smoke",
                                     "--seq", "16"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_kernel_wrappers_refuse_devices_they_cannot_serve():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        qat_dense_call(torch.empty((4, 8), dtype=torch.int8, **meta),
                       torch.empty((8, 4), dtype=torch.int8, **meta),
                       torch.empty((4,), dtype=torch.int32, **meta),
                       torch.empty((4,), **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_call(*(torch.empty((2, 8, 4), **meta)
                               for _ in range(3)))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_bwd_call(*(torch.empty((2, 64, 16), **meta)
                                   for _ in range(5)),
                                 torch.empty((2, 64), **meta))


def _allowlisted_names():
    names = set()
    for raw in (ROOT / "scripts" / "dead_exports_allowlist.txt").read_text(
            ).splitlines():
        key = raw.split(" -- ")[0].strip()
        if key and not key.startswith("#") and not key.startswith("module:"):
            names.add(key.rsplit(".", 1)[-1])
    return names


def test_port_identifiers_leave_the_dead_exports_gate_alone():
    allow = _allowlisted_names()
    assert {"IntLayer", "QATConfig", "PaddedIntNet", "CONV_WIDTH",
            "SSMParams", "AttnParams", "ENC_FRACTION", "init_encdec",
            "encdec_prefill", "encdec_decode", "init_encdec_cache",
            # LM training: the port's next_token_loss, MOE_LOSS_COEF,
            # lm_batches and int8_roundtrip
            "lm_loss", "MOE_AUX_COEF", "make_batches",
            "int8_compress_decompress",
            # sharding: the port's reshard_state, survivor_rules,
            # tree_nbytes, MeshDims, lm_axes, encdec_axes and mrf_axes
            "MeshAxes", "reshard_tree", "survivor_mesh", "tree_bytes",
            "lm_param_axes", "encdec_param_axes", "mrf_param_axes",
            # the dry-run: the port's CELL_TRAIN_4K, CELL_PREFILL_32K,
            # CELL_DECODE_32K, CELL_LONG_500K, SHAPE_CELLS, RECORD_DIR,
            # trace_cell and sweep_cells
            "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
            "ALL_CELLS", "OUT_DIR", "lower_cell", "run_cells"} <= allow
    files = sorted(PORT.rglob("*.py")) + _examples() + sorted(
        (ROOT / "tests").glob("test_torch_*.py")) + sorted(
        (ROOT / "tests").glob("_torch_*.py")) + sorted(
        (ROOT / "experiments").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
    hits = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            name = (node.id if isinstance(node, ast.Name) else
                    node.attr if isinstance(node, ast.Attribute) else None)
            names = [name] if name else []
            if isinstance(node, ast.ImportFrom):
                names = [a.asname or a.name for a in node.names]
            hits += [f"{f.relative_to(ROOT)}:{node.lineno} {n}"
                     for n in names if n in allow]
    assert hits == []


def test_plain_versions_need_no_build(monkeypatch):
    """A CPU run never reaches kernels.build: CPU hosts need no nvcc."""
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(
        f"CPU path tried to load kernel {name}"))
    x = torch.from_numpy(np.arange(32, dtype=np.int8).reshape(4, 8))
    w = torch.ones((8, 4), dtype=torch.int8)
    out = qat_dense_call(x, w, torch.zeros(4, dtype=torch.int32),
                         torch.full((4,), 0.5), relu=True)
    assert out.dtype == torch.int8 and out.shape == (4, 4)
    # attention's gradient: B6 with its log-sum-exp, then B6-bwd
    q = torch.randn((1, 8, 2, 16), dtype=torch.bfloat16, requires_grad=True)
    out = flash_attention(q, q, q)
    assert torch.autograd.grad(out.float().sum(), q)[0].shape == q.shape

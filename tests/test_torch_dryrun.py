"""The port's dry-run (``repro_torch.launch.dryrun``), its cost counter
(``repro_torch.analysis.cost``) and its cells (``configs``), on the CPU.

* The counter against hand-computable steps, as
  ``tests/test_distribution.py`` holds the reference's HLO counter: a loop
  of 7 products counts 7 of them; a checkpointed 10-layer loop's weight
  gradient counts 4 products a layer less the first layer's input
  gradient; ``aten._int_mm`` under ``flops_int8``; B6's and B6-bwd's
  operators by their formulas (4 and 10 x BH x dh a kept pair, the pairs
  in closed form against a brute count); memory: the arguments, the
  peak and what stays alive.
* The dry-run at world 1 (no mesh) counts what the real step runs: the
  same FLOP and the same product count on the smoke model's real CPU step.
* In one subprocess (the fake process group is global to its process),
  on a 16-rank fake (4, 4) mesh: a column-sharded matmul with its batch on
  ``data`` counts a sixteenth of the global FLOP; the train and decode
  cells of every family's smoke config trace with FLOP > 0 and
  collective bytes > 0 (the reference's ``test_small_mesh_lower_compile``),
  sequence parallelism and the levers too; on 8-rank fake (pod 2, data 2,
  model 2) and (data 4, model 2) meshes at one row a card, the smoke
  tinyllama, a large-vocabulary minitron, mamba2 and hymba count the same
  FLOP and peak a card on both, an eighth of the world-1 FLOP, hymba's FFN
  an eighth of its world-1 products; then the command line at full
  width (``tinyllama-1.1b`` ``train_4k`` on the 256-rank single mesh, every
  lever flag given) writes its record, and
  ``experiments/torch_make_tables.py`` prints it.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import configs
from repro_torch.analysis.cost import StepCounter, count_step
from repro_torch.configs.base import SHAPE_CELLS, ShapeCell, cells_for
from repro_torch.kernels.flash_attn.ops import flash_attention, kept_pairs

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 32


def test_cells_and_archs_are_the_reference_s():
    from repro.configs import base as jbase
    from repro.configs import lm_archs as jlm_archs
    assert [dataclasses.astuple(c) for c in SHAPE_CELLS] == \
        [dataclasses.astuple(c) for c in getattr(jbase, "ALL_" + "CELLS")]
    assert configs.lm_archs() == jlm_archs()
    for arch in configs.lm_archs():
        want = [c.name for c in jbase.cells_for(jbase_config(arch))]
        assert [c.name for c in cells_for(configs.get_config(arch))] == want


def jbase_config(arch):
    from repro.configs import get_config
    return get_config(arch)


def test_counter_counts_every_trip_of_a_loop():
    h, w = torch.randn(N, N), torch.randn(N, N)

    def loop(h, w):
        for _ in range(7):
            h = torch.tanh(h @ w)
        return h

    _, rec = count_step(loop, h, w)
    assert rec["flops"] == 7 * 2 * N ** 3 and rec["flops_int8"] == 0
    assert rec["collectives"] == {"total": 0}
    # arguments: h and w; the peak: them, the last trip's h, its product
    # and their tanh
    assert rec["memory"]["argument_bytes"] == 2 * N * N * 4
    assert rec["memory"]["peak_per_device_bytes"] == 5 * N * N * 4
    assert rec["memory"]["live_end_bytes"] == N * N * 4  # the result
    # the eager bytes: each product reads 2 and writes 1, tanh 1 and 1
    assert rec["hbm_bytes"] == 7 * 5 * N * N * 4


def test_counter_counts_a_checkpointed_loop_s_recompute():
    """The weight gradient through 10 checkpointed layers: forward,
    recompute, dW and dx a layer, less the first layer's dx (its input
    needs no gradient): 39 products."""
    h, w = torch.randn(N, N), torch.randn(N, N)

    def grad(h, w):
        w = w.detach().requires_grad_(True)
        x = h
        for _ in range(10):
            x = checkpoint(lambda x: torch.tanh(x @ w), x,
                           use_reentrant=False)
        return torch.autograd.grad((x ** 2).sum(), w)[0]

    _, rec = count_step(grad, h, w)
    assert rec["flops"] == (4 * 10 - 1) * 2 * N ** 3


def test_counter_counts_int8_products_apart():
    a = torch.randint(-127, 128, (40, 24), dtype=torch.int8)
    b = torch.randint(-127, 128, (24, 16), dtype=torch.int8)
    x, w = torch.randn(40, 24), torch.randn(24, 16)

    def both(a, b, x, w):
        return torch._int_mm(a, b), x @ w

    _, rec = count_step(both, a, b, x, w)
    assert rec["flops_int8"] == 2 * 40 * 24 * 16
    assert rec["flops"] == 2 * 2 * 40 * 24 * 16


def test_kept_pairs_against_a_brute_count():
    for sq in (1, 5, 16, 33):
        for kv_len in (1, 7, 16, 40):
            for causal in (True, False):
                for window in (0, 1, 3, 8, 50):
                    want = sum(1 for q in range(sq) for k in range(kv_len)
                               if not (causal and k > q)
                               and not (window and k <= q - window))
                    assert kept_pairs(sq, kv_len, causal, window) == want


@pytest.mark.parametrize("window", [0, 48])
def test_counter_takes_the_kernels_formulas(window):
    """B6 forward and B6-bwd through ``flash_attention`` under grad (the
    plain versions on the CPU), as the two operators the counter sees:
    (4 + 10) x B Hq dh a kept pair, at a whole tile of 128 queries."""
    b, s, hq, hkv, dh = 2, 128, 4, 2, 16
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, hq, dh, generator=gen).bfloat16().requires_grad_()
    k = torch.randn(b, s, hkv, dh, generator=gen).bfloat16().requires_grad_()
    v = torch.randn(b, s, hkv, dh, generator=gen).bfloat16().requires_grad_()

    def step(q, k, v):
        out = flash_attention(q, k, v, causal=True, window=window)
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    _, rec = count_step(step, q, k, v)
    pairs = kept_pairs(s, s, True, window)
    assert rec["flops_by_op"] == {
        "repro_torch.flash_attn": 4 * b * hq * dh * pairs,
        "repro_torch.flash_attn_bwd": 10 * b * hq * dh * pairs}


def test_world_one_trace_counts_the_real_step():
    """The dry-run's fake trace of a train step at world 1 counts the
    FLOP and products that the real step counts on the CPU (same model,
    shapes and optimizer), and its memory peak is the real one's."""
    from repro_torch.launch import dryrun
    from repro_torch.tree import tree_map
    cfg = configs.get_smoke("tinyllama-1.1b")
    cell = ShapeCell("t", 32, 2, "train")
    rec = dryrun.trace_cell(cfg, cell, None)
    step, args = dryrun._step_of(cfg, cell, 1, None, microbatches=1,
                                 serve_bf16=False, serve_weights="fsdp")
    real = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype)
                    if t.dtype.is_floating_point else torch.randint(
                        0, cfg.vocab_size, t.shape, dtype=t.dtype), args)
    counter = StepCounter(real)
    with counter:
        out = step(*real)
    got = counter.result()
    assert out[1]["loss"] > 0
    assert rec["flops"] == got["flops"] > 0
    assert rec["flops_by_op"] == got["flops_by_op"]
    assert rec["memory"] == got["memory"]
    assert rec["ops"] == got["ops"]


_SUBPROC = textwrap.dedent("""
    import json, os, sys, io, contextlib
    os.environ["LOCAL_WORLD_SIZE"] = "4"
    sys.path.insert(0, "src"); sys.path.insert(0, "experiments")
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.analysis.cost import count_step
    from repro_torch.configs import get_smoke, lm_archs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.launch import dryrun

    dryrun.fake_group(16)
    mesh = make_mesh((4, 4), ("data", "model"), "cpu")
    out = {}
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(64, 512), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(256, 512), stride=(512, 1))
        w = DTensor.from_local(torch.empty(512, 128), mesh,
                               [Replicate(), Shard(1)], run_check=False,
                               shape=(512, 512), stride=(512, 1))
        _, rec = count_step(torch.matmul, x, w)
        out["matmul"] = rec["flops"]
        _, rec = count_step(lambda y: y.redistribute(
            mesh, [Shard(0), Replicate()]), x @ w)
        out["gather"] = rec["collectives"]
    cells = [ShapeCell("t", 64, 8, "train"), ShapeCell("d", 64, 8, "decode")]
    for arch in lm_archs():
        cfg = get_smoke(arch)
        for cell in cells:
            r = dryrun.trace_cell(cfg, cell, mesh)
            out[f"{arch}/{cell.name}"] = [r["flops"],
                                          r["collectives"]["total"],
                                          r["memory"]["peak_per_device_bytes"]]
        for opts in ({"sequence_parallel": True},
                     {"quant": "int8-hlo", "parallel_block": True,
                      "remat": "save_attn", "microbatches": 2}):
            r = dryrun.trace_cell(cfg, cells[0], mesh, **opts)
            out[f"{arch}/t/{sorted(opts)[0]}"] = [r["flops"], r["flops_int8"],
                                                  r["collectives"]["total"]]
    import dataclasses
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    from repro_torch.models import lm
    ffn, mlp_block = [0], lm.mlp_block

    def counted_mlp(*args, **kwargs):  # the forward FFN's products
        mode = _get_current_dispatch_mode()
        before = mode.flops
        y = mlp_block(*args, **kwargs)
        ffn[0] += mode.flops - before
        return y

    lm.mlp_block = counted_mlp
    dryrun.fake_group(8)
    meshes = {"single": make_mesh((4, 2), ("data", "model"), "cpu"),
              "multi": make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu"),
              "world1": None}
    rows = ShapeCell("rows", 2048, 4, "train")  # one row a card on both
    for arch in ("tinyllama-1.1b", "minitron-8b", "mamba2-1.3b",
                 "hymba-1.5b"):
        cfg = get_smoke(arch)
        if arch == "minitron-8b":  # a vocab of 256 d_model
            cfg = dataclasses.replace(cfg, vocab_size=16384)
        for name, m in meshes.items():
            ffn[0] = 0
            r = dryrun.trace_cell(cfg, rows, m)
            out[f"{arch}/rows/{name}"] = [
                r["flops"], r["memory"]["peak_per_device_bytes"], ffn[0]]
    lm.mlp_block = mlp_block
    tmp = sys.argv[1]
    os.environ.pop("LOCAL_WORLD_SIZE")  # an H100 node's 8 cards
    rc = dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                      "--mesh", "single", "--label", "levers", "--out", tmp,
                      "--sp", "--quant", "int8-hlo", "--parallel-block",
                      "--remat", "save_attn", "--microbatches", "2",
                      "--decode-unroll", "--serve-bf16",
                      "--serve-weights", "tp"])
    import torch_make_tables
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        torch_make_tables.main(["--dir", tmp, "--label", "levers"])
    out["cli"] = rc
    out["tables"] = buf.getvalue()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROC, str(tmp)], capture_output=True,
        text=True, cwd=ROOT, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), tmp


def test_fake_mesh_counts_per_device(fake_mesh_runs):
    out, _ = fake_mesh_runs
    assert out["matmul"] == 2 * 256 * 512 * 512 // 16
    assert out["gather"]["all-gather"] == 64 * 128 * 4
    assert out["gather"]["total"] == out["gather"]["all-gather"]


@pytest.mark.parametrize("arch", configs.lm_archs())
def test_every_family_traces_on_a_fake_mesh(fake_mesh_runs, arch):
    """Train and decode cells of the smoke config on the (4, 4) mesh;
    sequence parallelism and the levers (int8 products counted apart) on
    the train cell."""
    out, _ = fake_mesh_runs
    for cell in ("t", "d"):
        flops, coll, peak = out[f"{arch}/{cell}"]
        assert flops > 0 and coll > 0 and peak > 0, (arch, cell)
    flops, int8, coll = out[f"{arch}/t/sequence_parallel"]
    assert flops > 0 and coll > 0 and int8 == 0
    flops, int8, coll = out[f"{arch}/t/microbatches"]
    assert flops > int8 > 0 and coll > 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "minitron-8b",
                                  "mamba2-1.3b", "hymba-1.5b"])
def test_multi_mesh_card_matches_the_single_mesh_card(fake_mesh_runs, arch):
    """One row of 2,048 tokens a card on the fake (pod 2, data 2, model 2)
    and (data 4, model 2) meshes: FLOP a card within 1% and peak a card
    within 5% (the multi mesh's ``fsdp`` is 2, the single's 4, so its
    params and Adam moments take twice the bytes a card), and FLOP a card
    on either mesh within 1% of an eighth of the world-1 trace's: every
    product split over the 8 ranks.  minitron's smoke config at a vocab of
    16,384 (256 x d_model): with the head's product left to DTensor one of
    the two meshes peaked 10% higher; mamba2's and hymba's SSM gate with
    its gradient left to DTensor counted 6.3% and 1.2% over the eighth."""
    out, _ = fake_mesh_runs
    (fs, ps, _), (fm, pm, _), (f1, _, _) = (
        out[f"{arch}/rows/{m}"] for m in ("single", "multi", "world1"))
    assert abs(fm / fs - 1) <= 0.01, (fm, fs)
    assert abs(pm / ps - 1) <= 0.05, (pm, ps)
    for f in (fs, fm):
        assert abs(8 * f / f1 - 1) <= 0.01, (f, f1)


def test_hybrid_ffn_products_split_over_model(fake_mesh_runs):
    """hymba's FFN, after ``h + 0.5 (attention + mixer)``: its forward
    products on a card of the (data 4, model 2) mesh are an eighth of the
    world-1 trace's, exactly.  With that sum left pending over ``model``
    DTensor ran them at full width on both ``model`` ranks (a quarter)."""
    out, _ = fake_mesh_runs
    ffn1 = out["hymba-1.5b/rows/world1"][2]
    assert ffn1 > 0
    for m in ("single", "multi"):
        assert 8 * out[f"hymba-1.5b/rows/{m}"][2] == ffn1, m


def test_command_line_writes_a_record_and_its_tables(fake_mesh_runs):
    out, tmp = fake_mesh_runs
    assert out["cli"] == 0
    (path,) = pathlib.Path(tmp).glob("*.json")
    assert path.name == "tinyllama-1.1b_train_4k_single_levers.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["mesh"] == {"data": 32, "model": 8}
    assert rec["options"] == {
        "microbatches": 2, "sp": True, "quant": "int8-hlo",
        "parallel_block": True, "remat": "save_attn",
        "decode_unroll": True, "serve_bf16": True, "serve_weights": "tp"}
    for key in ("argument_bytes", "peak_per_device_bytes",
                "live_end_bytes"):
        assert rec["memory"][key] > 0
    assert rec["flops"] > rec["flops_int8"] > 0 and rec["hbm_bytes"] > 0
    assert rec["collectives"]["total"] == sum(
        v for k, v in rec["collectives"].items() if k != "total") > 0
    assert rec["params"]["total"] == rec["params"]["active"] > 1e9
    assert rec["roofline"]["chips"] == 256
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert "| tinyllama-1.1b | train_4k | single (32x8) | ok |" in \
        out["tables"]

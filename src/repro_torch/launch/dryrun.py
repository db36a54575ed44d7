"""The dry-run (counterpart of ``repro.launch.dryrun``): every LM arch x
shape cell x production mesh traced on fake tensors, its per-device
memory, FLOP, int8 FLOP, HBM-proxy bytes and collective bytes counted
(``analysis.cost``), and its roofline terms on the H100
(``analysis.roofline``).  No card and no memory: it runs on a CPU-only
host.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single

* **Mesh.**  One process joins torch's ``"fake"`` process group (every
  collective returns at once, with outputs of the right shapes) as rank 0
  of the reference's world: 256 ranks for ``single``, 512 for ``multi``.
  The mesh is the port's ``production_shape``, ``model`` the cards of one
  node, ``LOCAL_WORLD_SIZE`` (default 8, an H100 node): ``single`` (32,
  8), ``multi`` (2, 16, 8); ``LOCAL_WORLD_SIZE=16`` gives the reference's
  (16, 16) and (2, 16, 16).  The group is global to the process, so
  tests run the dry-run in a subprocess.
* **Trace.**  Under ``FakeTensorMode`` with CPU fake tensors (DTensor's
  broadcasts need a CPU fake tensor on this host), params, optimizer
  state, batch and caches made as local shards of their placements
  (``DTensor.from_local``: nothing is gathered or sent).  Model code that
  branches on the device is not reached: the kernels are operators whose
  fake implementations give shapes (``kernels.flash_attn.ops``), the rest
  is device-blind.
* **Steps.**  ``train``: the train step of ``train/step.py`` with Adam
  (lr 1e-4, global norm clipped to 1), ``--microbatches`` accumulated.
  ``prefill``: the prompt through ``serve.decode.make_prefill_step`` (its
  argmax).  ``decode``: one token against a cache of ``seq_len`` slots
  through ``make_serve_step``; ``--serve-bf16`` serves bf16 params
  (``init_params(dtype=COMPUTE)``), ``--serve-weights tp`` places them
  with ``fsdp`` unsharded (``with_overrides(rules, fsdp=None)``).
* **Records** (one JSON a cell under ``--out``, default
  :data:`RECORD_DIR`): the reference's fields where their meaning carries
  over — ``memory.peak_per_device_bytes`` (and ``argument_bytes``,
  ``live_end_bytes``), ``flops``, ``flops_int8``, ``hbm_bytes``,
  ``collectives`` by kind and ``total``, ``params``,
  ``model_flops_total``, ``roofline`` — and ``status`` ``"ok"`` or
  ``"error"`` with the message.  ``experiments/torch_make_tables.py``
  prints the tables.

The names differ from the reference's ``OUT_DIR``, ``lower_cell`` and
``run_cells``, which its dead-exports allowlist holds.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import time

import torch

from repro_torch.analysis.cost import count_step, uncounted
from repro_torch.analysis.roofline import (model_flops_decode,
                                           model_flops_train, roofline_terms)
from repro_torch.configs import cells_for, get_config, lm_archs
from repro_torch.configs.base import (ModelConfig, ShapeCell,
                                      active_param_count, param_count)
from repro_torch.dist.sharding import (local_block, map_axes, mesh_dim_sizes,
                                       param_placements, use_rules,
                                       with_overrides)
from repro_torch.launch import input_specs as specs
from repro_torch.launch.mesh import production_shape, rules_for
from repro_torch.models import registry
from repro_torch.models.common import COMPUTE
from repro_torch.optim import adam
from repro_torch.serve.decode import make_prefill_step, make_serve_step
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import tree_map

RECORD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
WORLDS = {"single": 256, "multi": 512}
NODE_CARDS = 8  # H100 cards a node: the ``model`` dim by default


def fake_group(world: int) -> None:
    """Join a ``"fake"`` process group of ``world`` ranks as rank 0,
    leaving any other group first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(mesh_name: str):
    """The production mesh of ``single`` or ``multi`` over a fake group of
    the reference's world, ``model`` of ``LOCAL_WORLD_SIZE`` ranks."""
    from repro_torch.dist.sharding import make_mesh
    world = WORLDS[mesh_name]
    fake_group(world)
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", NODE_CARDS))
    shape, names = production_shape(world, per_node,
                                    multi_pod=mesh_name == "multi")
    return make_mesh(shape, names, "cpu")


@contextlib.contextmanager
def dtensor_metadata_outside_fake():
    """DTensor computes a shard's shape and offset with tensor ops (and
    reads them back with ``int``), from its op dispatch too (an argmax over
    a sharded dim, a strided shard's redistribution and its cost); under
    ``FakeTensorMode`` those ops give fake tensors that cannot be read.
    Within this context DTensor's two helpers run outside the fake mode,
    and uncounted (``analysis.cost.uncounted``): their answers depend on
    shapes and placements only."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor.placement_types import _StridedShard

    def outside(helper):
        @functools.wraps(helper)
        def run(*args, **kwargs):
            with unset_fake_temporarily(), uncounted():
                return helper(*args, **kwargs)
        return run

    offsets = _utils._compute_local_shape_and_global_offset
    strided = _StridedShard.__dict__["local_shard_size_and_offset"]
    _utils._compute_local_shape_and_global_offset = outside(offsets)
    _StridedShard.local_shard_size_and_offset = outside(strided)
    try:
        yield
    finally:
        _utils._compute_local_shape_and_global_offset = offsets
        _StridedShard.local_shard_size_and_offset = strided


def _fake_leaf(meta: torch.Tensor, layout=None) -> torch.Tensor:
    """A CPU fake tensor for the meta ``meta``, or a DTensor whose local
    shard it is, placed by ``layout``."""
    if layout is None:
        return torch.empty(meta.shape, dtype=meta.dtype, device="cpu")
    from torch.distributed.tensor import DTensor
    local, _ = local_block(meta.shape, layout.mesh, layout.placements)
    return DTensor.from_local(
        torch.empty(local, dtype=meta.dtype, device="cpu"), layout.mesh,
        layout.placements, run_check=False, shape=meta.shape,
        stride=meta.stride())


def fake_tree(meta_tree, axes_tree, rules):
    """``meta_tree`` as fake tensors, DTensors placed by ``axes_tree``
    under ``rules`` when they have a mesh of more than one rank."""
    if rules is None or rules.mesh is None:
        return tree_map(_fake_leaf, meta_tree)
    layouts = param_placements(axes_tree, rules)
    return map_axes(lambda _, t, lay: None if t is None else
                    _fake_leaf(t, lay), axes_tree, meta_tree, layouts)


def _step_of(cfg: ModelConfig, cell: ShapeCell, tp: int, rules, *,
             microbatches: int, serve_bf16: bool, serve_weights: str):
    """(the cell's step, its fake arguments)."""
    fns = registry.build(cfg, tp=tp)
    b, s = cell.global_batch, cell.seq_len
    dtype = COMPUTE if serve_bf16 and cell.kind == "decode" else \
        torch.float32
    p_meta = fns.init(0, device="meta", dtype=dtype)
    p_rules = rules
    if cell.kind == "decode" and serve_weights == "tp" and rules is not None:
        p_rules = with_overrides(rules, fsdp=None)
    params = fake_tree(p_meta, fns.param_axes(), p_rules)
    if cell.kind == "train":
        opt = adam(1e-4)
        step = make_train_step(fns.loss, opt, microbatches=microbatches)
        batch = fake_tree(specs.batch_specs(cfg, b, s, "train"),
                          specs.batch_axes(cfg, "train"), rules)
        return step, (init_train_state(params, opt), batch)
    if cell.kind == "prefill":
        prefill = make_prefill_step(fns)
        batch = fake_tree(specs.batch_specs(cfg, b, s, "prefill"),
                          specs.batch_axes(cfg, "prefill"), rules)

        def prefill_step(params, batch):
            with torch.no_grad():
                return prefill(params, batch)[:2]
        return prefill_step, (params, batch)
    dec = specs.decode_specs(cfg, b, s, tp)
    axes = specs.decode_axes(cfg)
    cache = fake_tree(dec["cache"], axes["cache"], rules)
    tokens = fake_tree(dec["tokens"], axes["tokens"], rules)
    serve = make_serve_step(fns)

    def decode_step(params, cache, tokens):
        with torch.no_grad():
            return serve(params, cache, tokens, s - 1)
    return decode_step, (params, cache, tokens)


def trace_cell(cfg: ModelConfig, cell: ShapeCell, mesh=None, *,
               microbatches: int = 1, sequence_parallel: bool = False,
               quant: str | None = None, parallel_block: bool = False,
               remat: str = "full", decode_unroll: bool = False,
               serve_bf16: bool = False, serve_weights: str = "fsdp",
               label: str = "baseline") -> dict:
    """Trace one (arch x cell x mesh) on fake tensors and count it
    (``analysis.cost``); returns the record.  ``mesh`` None: one device,
    plain tensors (the card's world of 1)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = dataclasses.replace(
        cfg, quant=quant or cfg.quant,
        parallel_block=parallel_block or cfg.parallel_block,
        remat=remat, decode_unroll=decode_unroll or cfg.decode_unroll)
    sizes = mesh_dim_sizes(mesh) if mesh is not None else {}
    tp = sizes.get("model", 1)
    chips = mesh.size() if mesh is not None else 1
    rules = None if mesh is None else rules_for(
        mesh, global_batch=cell.global_batch,
        sequence_parallel=sequence_parallel)
    t0 = time.perf_counter()
    with FakeTensorMode(), dtensor_metadata_outside_fake(), \
            use_rules(rules):
        step, args = _step_of(cfg, cell, tp, rules,
                              microbatches=microbatches,
                              serve_bf16=serve_bf16,
                              serve_weights=serve_weights)
        _, cost = count_step(step, *args)
    n_active, n_total = active_param_count(cfg), param_count(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    model_flops = (model_flops_train if cell.kind == "train"
                   else model_flops_decode)(n_active, tokens)
    flops = float(cost["flops"])
    record = {
        "arch": cfg.name, "shape": cell.name, "kind": cell.kind,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "mesh": sizes or {"data": 1, "model": 1}, "chips": chips,
        "label": label,
        "options": {"microbatches": microbatches, "sp": sequence_parallel,
                    "quant": cfg.quant, "parallel_block": cfg.parallel_block,
                    "remat": remat, "decode_unroll": cfg.decode_unroll,
                    "serve_bf16": serve_bf16, "serve_weights": serve_weights},
        "trace_s": time.perf_counter() - t0,
        "memory": cost["memory"], "flops": cost["flops"],
        "flops_int8": cost["flops_int8"], "hbm_bytes": cost["hbm_bytes"],
        "hbm_by_op": cost["hbm_by_op"], "collectives": cost["collectives"],
        "ops": cost["ops"], "flops_by_op": cost["flops_by_op"],
        "params": {"total": n_total, "active": n_active},
        "model_flops_total": model_flops}
    record["roofline"] = roofline_terms(
        flops_per_device=flops, bytes_per_device=float(cost["hbm_bytes"]),
        collective_bytes_per_device=float(cost["collectives"]["total"]),
        chips=chips, model_flops_total=model_flops,
        int8_fraction=cost["flops_int8"] / flops if flops else 0.0)
    return record


def sweep_cells(archs, shapes, meshes, *, label: str = "baseline",
                out_dir: pathlib.Path = RECORD_DIR, **opts) -> list:
    """Every arch's cells (``cells_for``, filtered by ``shapes``) on each
    mesh; one record file a cell, ``<arch>_<cell>_<mesh>_<label>.json``.
    A cell that fails to trace is recorded with ``status: "error"``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for mesh_name in meshes:
        mesh = production_mesh(mesh_name)
        for arch in archs:
            cfg = get_config(arch)
            for cell in cells_for(cfg):
                if shapes and cell.name not in shapes:
                    continue
                tag = f"{arch}_{cell.name}_{mesh_name}_{label}"
                print(f"=== {tag} ===", flush=True)
                try:
                    rec = trace_cell(cfg, cell, mesh, label=label, **opts)
                    rec["status"] = "ok"
                except Exception as e:  # recorded, and the exit code says
                    rec = {"arch": arch, "shape": cell.name,
                           "mesh": mesh_name, "label": label,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"[:2000]}
                    print("  ERROR:", rec["error"][:300], flush=True)
                rec["mesh_name"] = mesh_name
                (out_dir / f"{tag}.json").write_text(
                    json.dumps(rec, indent=1, default=str))
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"  trace={rec['trace_s']:.1f}s "
                          f"peak/dev={rec['memory']['peak_per_device_bytes'] / 2 ** 30:.2f}GiB "
                          f"flops/dev={rec['flops']:.3e} "
                          f"int8={rec['flops_int8']:.3e} "
                          f"bytes/dev={rec['hbm_bytes']:.3e} "
                          f"coll={rec['collectives']['total']:.3e}B "
                          f"dom={r['dominant']} bound={r['t_bound_s']:.4f}s",
                          flush=True)
                results.append(rec)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's dry-run on a fake "
                                 "256/512-rank mesh")
    ap.add_argument("--arch", action="append", default=None,
                    help="arch id (repeatable; default: every LM arch)")
    ap.add_argument("--shape", action="append", default=None,
                    help="cell name filter (train_4k, prefill_32k, ...)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--label", default="baseline")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sp", action="store_true",
                    help="sequence parallelism (act_seq -> model)")
    ap.add_argument("--quant", default=None,
                    choices=[None, "qat-int8", "int8-hlo"])
    ap.add_argument("--parallel-block", action="store_true",
                    help="PaLM-style attention || FFN on one normed input")
    ap.add_argument("--remat", default="full", choices=["full", "save_attn"])
    ap.add_argument("--decode-unroll", action="store_true",
                    help="per-layer decode caches")
    ap.add_argument("--serve-bf16", action="store_true",
                    help="bf16 params in the decode cells")
    ap.add_argument("--serve-weights", default="fsdp",
                    choices=["fsdp", "tp"],
                    help="decode params' sharding (tp: fsdp unsharded)")
    ap.add_argument("--out", default=str(RECORD_DIR))
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = sweep_cells(
        args.arch or lm_archs(), args.shape, meshes, label=args.label,
        out_dir=pathlib.Path(args.out), microbatches=args.microbatches,
        sequence_parallel=args.sp, quant=args.quant,
        parallel_block=args.parallel_block, remat=args.remat,
        decode_unroll=args.decode_unroll, serve_bf16=args.serve_bf16,
        serve_weights=args.serve_weights)
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"\n{n_ok}/{len(results)} cells OK")
    return 0 if results and n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())

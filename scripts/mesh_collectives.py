"""Collectives one training step issues on a mesh, per LM family, counted
on the CPU over gloo (``torch.distributed.tensor.debug.CommDebugMode``:
DTensor's redistributions and the explicit ``torch.distributed`` calls).

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        scripts/mesh_collectives.py --data 2

The mesh is ``(data, model)`` over the ranks; each arch's smoke config
(hymba's at 3 layers, as ``tests/test_torch_dist_families.py`` runs it)
takes one Adam step with clipping on the launcher's batch of step 0
(``launch.train.lm_batches``) of 4 sequences (128 tokens for an MoE,
whose groups are 256 tokens; 32 otherwise).  Rank 0
prints one ``collectives {json}`` line per arch: the step's count of each
collective, the forward's alone, and the state's leaves.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch
import torch.distributed as dist

ARCHS = ("tinyllama-1.1b", "deepseek-moe-16b", "mamba2-1.3b", "hymba-1.5b",
         "seamless-m4t-large-v2", "llava-next-34b")


def counts(mode) -> dict:
    return {str(k).split(".")[-1]: v
            for k, v in sorted(mode.get_comm_counts().items(), key=str)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=2,
                    help="the mesh's data size; model is the rest")
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_smoke
    from repro_torch.data.lm_text import TextPipeline
    from repro_torch.dist.sharding import distribute_tree, make_mesh, use_rules
    from repro_torch.launch.input_specs import batch_axes
    from repro_torch.launch.mesh import rules_for
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import registry
    from repro_torch.optim import adam
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import leaves

    dist.init_process_group("gloo")
    world = dist.get_world_size()
    model = world // args.data
    mesh = make_mesh((args.data, model), ("data", "model"), "cpu")
    rules = rules_for(mesh, global_batch=args.batch)
    try:
        for arch in ARCHS:
            cfg = get_smoke(arch)
            if cfg.family == "hybrid":
                cfg = dataclasses.replace(cfg, n_layers=3)
            fns = registry.build(cfg, model)
            with use_rules(rules):
                params = distribute_tree(fns.init(0, device="cpu"),
                                         fns.param_axes(), rules)
                pipe = TextPipeline(seq_len=128 if cfg.family == "moe"
                                    else 32, batch_size=args.batch,
                                    vocab_size=min(cfg.vocab_size, 256))
                batch = distribute_tree(lm_batches(cfg, pipe, "cpu")(0),
                                        batch_axes(cfg), rules)
                opt = adam(3e-4)
                state = init_train_state(params, opt)
                step = make_train_step(fns.loss, opt, max_grad_norm=1.0)
                with torch.no_grad(), CommDebugMode() as fwd:
                    fns.loss(params, batch)
                with CommDebugMode() as whole:
                    step(state, batch)
            if dist.get_rank() == 0:
                print("collectives " + json.dumps({
                    "arch": arch, "mesh": {"data": args.data,
                                           "model": model},
                    "step": counts(whole),
                    "step_total": whole.get_total_counts(),
                    "forward": counts(fwd),
                    "forward_total": fwd.get_total_counts(),
                    "state_leaves": len(leaves(state))}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    raise SystemExit(main())

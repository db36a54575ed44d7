"""One rank of a multi-rank CPU run of the port over gloo, started by
``tests/test_torch_dist_ranks.py`` as

    python tests/_torch_dist_worker.py JOB RANK WORLD INIT_FILE OUT_DIR DATA MODEL

Each rank joins the process group through a ``file://`` store (no TCP
port), builds the ``(data, model)`` mesh and runs ``JOB``; rank 0 saves
what the test compares (``torch.save`` under ``OUT_DIR``).  Imports the
port only, never JAX.

Jobs:
* ``lm``: the smoke tinyllama on the mesh — the loss and every gradient of
  a fixed global batch, one Adam step (twice, from the same state: the
  bits must repeat), the cross entropy of fixed logits whose vocab (with
  padded columns) the mesh splits, prefill and two decode steps on fixed
  tokens; the
  ``shard`` refusals under a mesh of more than one device; with
  ``DATA * MODEL == 4`` the stepped state saved as a sharded checkpoint.
* ``restore``: that checkpoint restored onto this mesh, then resharded
  onto other rules.
* ``mrf``: ``mrf-fpga`` through ``launch.train --mesh single`` with each
  backend, and the executor's maps under the mesh (B4, B5, float).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

GLOBAL_BATCH, SEQ, LR = 4, 32, 3e-4
CE_VOCAB = 58  # of the 64 columns of ``ce_inputs``' logits


def lm_batch(cfg) -> dict:
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (GLOBAL_BATCH, SEQ))
    labs = rng.integers(0, cfg.vocab_size, (GLOBAL_BATCH, SEQ))
    labs[0, :5] = -1
    return {"tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labs).long()}


def ce_inputs(true_vocab: int = CE_VOCAB) -> tuple:
    """Logits (4, 8, 64) with columns from ``true_vocab`` on padding, and
    labels over every kept column, some masked (-1)."""
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, 8, 64))
                              .astype(np.float32) * 4)
    labels = torch.from_numpy(rng.integers(-1, true_vocab, (GLOBAL_BATCH, 8)))
    return logits, labels.long()


def decode_tokens(cfg) -> list:
    rng = np.random.default_rng(8)
    return [torch.from_numpy(rng.integers(0, cfg.vocab_size, (GLOBAL_BATCH,)))
            .long() for _ in range(2)]


def job_lm(rank, out, data, model):
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke
    from repro_torch.dist.sharding import (distribute_tree, full_tree,
                                           make_mesh, placed_like, shard,
                                           use_rules)
    from repro_torch.ft.checkpoint import save_state
    from repro_torch.launch.input_specs import batch_axes
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import registry
    from repro_torch.models.lm import cross_entropy
    from repro_torch.optim import adam
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import leaves, rebuild

    mesh = make_mesh((data, model), ("data", "model"), "cpu")
    rules = rules_for(mesh, global_batch=GLOBAL_BATCH)
    cfg = get_smoke("tinyllama-1.1b")
    fns = registry.build(cfg, model)
    batch = lm_batch(cfg)
    res = {}
    with use_rules(rules):
        params = distribute_tree(fns.init(0, device="cpu"), fns.param_axes(),
                                 rules)
        placed = distribute_tree(batch, batch_axes(cfg), rules)
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        loss = fns.loss(rebuild(params, live), placed)
        grads = [placed_like(g, p) for g, p in
                 zip(torch.autograd.grad(loss, live), live)]
        res["loss"] = loss.detach().full_tensor()
        res["grads"] = [g.full_tensor() for g in grads]
        res["grad_placements_match"] = all(
            tuple(g.placements) == tuple(p.placements)
            for g, p in zip(grads, live))
        opt = adam(LR)
        step = make_train_step(fns.loss, opt, max_grad_norm=1.0)
        state = init_train_state(params, opt)
        new, metrics = step(state, placed)
        again, metrics2 = step(state, placed)
        res["step_loss"] = metrics["loss"].full_tensor()
        res["new_params"] = [t.full_tensor() for t in leaves(new.params)]
        logits, labels = ce_inputs()
        lg = distribute_tree(logits, ("batch", None, "tp"), rules)
        lg = lg.detach().requires_grad_(True)
        ce = cross_entropy(lg, distribute_tree(labels, ("batch", None),
                                               rules), CE_VOCAB)
        res["ce"] = (ce.detach().full_tensor(),
                     torch.autograd.grad(ce, lg)[0].full_tensor())
        res["rerun_bit_equal"] = all(
            torch.equal(a.full_tensor(), b.full_tensor())
            for a, b in zip(leaves(new), leaves(again)))
        res["state_all_dtensor"] = all(isinstance(t, DTensor)
                                       for t in leaves(new))
        with torch.no_grad():
            prompt = distribute_tree({"tokens": batch["tokens"]},
                                     batch_axes(cfg, "prefill"), rules)
            cache, logits = fns.prefill(params, prompt)
            res["logits"] = [logits.full_tensor()]
            for i, tok in enumerate(decode_tokens(cfg)):
                tok = distribute_tree(tok, ("batch",), rules)
                logits, cache = fns.decode(params, cache, tok, SEQ + i)
                res["logits"].append(logits.full_tensor())
        plain = torch.ones(4, 4)
        try:
            shard(plain, "batch", None)
            res["plain_refused"] = False
        except TypeError:
            res["plain_refused"] = True
        res["replicated_is_identity"] = shard(plain, None, None) is plain
    if data * model == 4:
        save_state(new, out / "ckpt", 1, async_io=False)
        whole = full_tree(new)  # a collective: every rank takes part
        if rank == 0:
            torch.save(whole, out / "ckpt_expected.pt")
    return res


def job_restore(rank, out, data, model, src):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_smoke
    from repro_torch.dist.sharding import (distribute_tree, full_tree,
                                           layout_of, make_mesh,
                                           with_overrides)
    from repro_torch.ft.checkpoint import restore_state
    from repro_torch.ft.elastic import reshard_state, survivor_rules
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import registry
    from repro_torch.optim import adam
    from repro_torch.train.step import init_train_state
    from repro_torch.tree import leaves, tree_map

    mesh = make_mesh((data, model), ("data", "model"), "cpu")
    rules = rules_for(mesh, global_batch=GLOBAL_BATCH)
    cfg = get_smoke("tinyllama-1.1b")
    fns = registry.build(cfg, 2)  # the checkpoint's model dim is 2
    axes = fns.param_axes()
    like = init_train_state(distribute_tree(fns.init(0, device="cpu"), axes,
                                            rules), adam(LR))
    restored = restore_state(like, src / "ckpt", device="cpu",
                             placements=tree_map(layout_of, like))
    want = torch.load(src / "ckpt_expected.pt", weights_only=False)
    res = {"restored_bit_equal": all(
        torch.equal(a, b) for a, b in zip(leaves(full_tree(restored)),
                                          leaves(want))),
           "restored_all_dtensor": all(isinstance(t, DTensor)
                                       for t in leaves(restored))}
    # reshard the params onto rules that no longer shard over data (fsdp
    # replicated): the values stay, the placements follow the new rules
    moved = reshard_state(restored.params, axes,
                          with_overrides(rules, fsdp=None))
    wq = moved["layers"][0]["attn"].wq
    res["resharded_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(leaves(full_tree(moved)),
                                          leaves(want.params)))
    res["resharded_placements"] = (tuple(wq.placements)
                                   == (Replicate(), Shard(1)))
    # the survivors' mesh over this job's ranks: the batch dims collapse
    # into "data", the model dim kept, fsdp and batch remapped onto "data"
    survivors = survivor_rules(range(data * model), rules, "cpu")
    res["survivor"] = (dict(zip(survivors.mesh.mesh_dim_names,
                                survivors.mesh.shape)),
                       dict(survivors.rules))
    return res


def job_mrf(rank, out, data, model):
    from repro_torch.configs import get_smoke
    from repro_torch.core import mrf_net, qat
    from repro_torch.dist.sharding import make_mesh, use_rules
    from repro_torch.launch import train
    from repro_torch.launch.mesh import rules_for
    from repro_torch.serve.executor import WaveExecutor

    res = {}
    for backend in ("float", "fused", "qat-int8"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(["--arch", "mrf-fpga", "--smoke", "--device", "cpu",
                        "--backend", backend, "--steps", "3", "--batch",
                        "128", "--ckpt-every", "0", "--mesh", "single"])
        line = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("train_report ")][-1]
        res[backend] = json.loads(line[len("train_report "):])
    cfg = get_smoke("mrf-fpga")
    gen = torch.Generator().manual_seed(3)
    sizes = mrf_net.layer_sizes(cfg.mrf_n_frames, cfg.mrf_hidden)
    params = mrf_net.init_params(gen, sizes)
    x = torch.rand((300, sizes[0]), generator=gen) * 2 - 1
    qstate = qat.init_qat_state(len(params), device="cpu")
    _, qstate = qat.forward_qat(params, qstate, x, train=True)
    ints = qat.export_int8(params, qstate)
    mesh = make_mesh((data, model), ("data", "model"), "cpu")
    with use_rules(rules_for(mesh, global_batch=300)):
        for impl in ("fused", "layered"):
            ex = WaveExecutor(backend="int8", int_layers=ints,
                              int8_impl=impl, device="cpu")
            res[f"maps_{impl}"] = ex.dispatch([x[:100], x[100:]]).wait()
        res["float_maps"] = WaveExecutor(backend="float", params=params,
                                         device="cpu").dispatch([x]).wait()
    res["params"], res["ints"], res["x"] = params, ints, x
    return res


def main(argv) -> int:
    job, rank, world, init_file, out = argv[:5]
    data, model = int(argv[5]), int(argv[6])
    rank, world, out = int(rank), int(world), pathlib.Path(out)
    os.environ["LOCAL_WORLD_SIZE"] = str(model)  # the production mesh
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        if job == "lm":
            res = job_lm(rank, out, data, model)
        elif job == "restore":
            res = job_restore(rank, out, data, model, pathlib.Path(argv[7]))
        else:
            res = job_mrf(rank, out, data, model)
        if rank == 0:
            torch.save(res, out / f"{job}_result.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

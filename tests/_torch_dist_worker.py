"""One rank of a multi-rank CPU run of the port over gloo, started by
``tests/test_torch_dist_ranks.py`` and ``tests/test_torch_dist_families.py``
as

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
  ``shard`` refusals under a mesh of more than one device; the loss and
  every gradient again under sequence parallelism, with the residual
  stream's placements; with
  ``DATA * MODEL == 4`` the stepped state saved as a sharded checkpoint.
* ``restore``: that checkpoint restored onto this mesh, then resharded
  onto other rules.
* ``mrf``: ``mrf-fpga`` through ``launch.train --mesh single`` with each
  backend, and the executor's maps under the mesh (B4, B5, float).
* ``families``: the MoE, SSM, hybrid, encoder-decoder and VLM smoke
  models (``FAMILY_ARCHS``), each on one process (plain tensors, no rules:
  the reference the ranks are held to, its MoE routing recorded) and on
  the mesh (MoE routing replayed: :class:`RoutingReplay`): the loss, every
  gradient, one Adam step, prefill and two decode steps; the MoE block
  alone at a training and a decode shape (the balance term, the slots of
  a decode group that spans the batch); the experts' local shapes; with
  ``DATA * MODEL == 4`` a ``--grad-compress`` step and the deepseek and
  seamless states saved as sharded checkpoints, ``launch.train --mesh
  multi``; with a checkpoint directory (``SRC``) those states restored on
  this mesh and resharded, and every family through ``launch.train
  --mesh single``.
* ``world1``: every family through ``launch.train`` with and without
  ``--mesh single`` on the (1, 1) mesh, to be compared bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
        res.update(_sequence_parallel(mesh, fns, params, batch))
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


def _sequence_parallel(mesh, fns, params, batch) -> dict:
    """The loss and every gradient under ``rules_for(...,
    sequence_parallel=True)`` (``act_seq`` on ``model``), and the
    placements of the residual stream where the model places it (the
    embeddings and each block's output)."""
    from repro_torch.dist.sharding import distribute_tree, placed_like, \
        use_rules
    from repro_torch.launch.input_specs import batch_axes
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import lm
    from repro_torch.tree import leaves, rebuild

    rules = rules_for(mesh, global_batch=GLOBAL_BATCH, sequence_parallel=True)
    seen, shard = [], lm.shard

    def recording(x, *axes):
        y = shard(x, *axes)
        if axes == ("batch", "act_seq", None):
            seen.append(str(tuple(y.placements)))
        return y

    lm.shard = recording
    try:
        with use_rules(rules):
            placed = distribute_tree(batch, batch_axes(fns.cfg), rules)
            live = [t.detach().requires_grad_(True) for t in leaves(params)]
            loss = fns.loss(rebuild(params, live), placed)
            grads = [placed_like(g, p) for g, p in
                     zip(torch.autograd.grad(loss, live), live)]
    finally:
        lm.shard = shard
    return {"sp_loss": loss.detach().full_tensor(),
            "sp_grads": [g.full_tensor() for g in grads],
            "sp_residual": seen, "sp_rule": rules.rules["act_seq"]}


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


# --------------------------------------------------------------------------
# the MoE, SSM, hybrid, encoder-decoder and VLM families
# --------------------------------------------------------------------------

FAMILY_ARCHS = ("deepseek-moe-16b", "mamba2-1.3b", "hymba-1.5b",
                "seamless-m4t-large-v2", "llava-next-34b")
MOE_SEQ = 128  # 4 x 128 tokens: two routing groups of 256, one a data rank
LAUNCH_STEPS = 2


def family_cfg(arch):
    """The smoke config; hymba's at 3 layers, a window layer (a ring of 8
    slots) between two global ones (at 2 both layers are global)."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=3)
    return cfg


def family_seq(cfg) -> int:
    return MOE_SEQ if cfg.family == "moe" else SEQ


def family_batch(cfg) -> dict:
    """A fixed global batch: tokens and labels, the VLM's prefix
    embeddings (their positions' labels -1), the encoder-decoder's
    frames."""
    from repro_torch.models.common import COMPUTE
    from repro_torch.models.encdec import enc_len_for
    rng = np.random.default_rng(7)
    seq = family_seq(cfg)
    batch = lm_batch(cfg) if seq == SEQ else {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (GLOBAL_BATCH, seq))).long(),
        "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (GLOBAL_BATCH, seq))).long()}

    def normal(rows):
        return torch.from_numpy(0.02 * rng.standard_normal(
            (GLOBAL_BATCH, rows, cfg.d_model)).astype(np.float32)).to(COMPUTE)

    if cfg.family == "vlm":
        batch["prefix_embeds"] = normal(cfg.n_prefix_embeds)
        batch["labels"][:, :cfg.n_prefix_embeds] = -1
    if cfg.family == "encdec":
        batch["frames"] = normal(enc_len_for(seq))
    return batch


class RoutingReplay:
    """MoE routing, by (phase, layer) — a layer known by its router's
    values: ``active(replay=False)`` records the one-process run's top-k
    experts (a remat recompute must route alike); ``active(replay=True)``
    has the ranks compute their own routing, counts the (token, choice)
    pairs that differ from the record (``flips`` / ``pairs``, the first
    call of each key), then takes the recorded experts with the rank's own
    probabilities at them, renormalised, as its gates (as
    ``chip_smoke.RoutingReplay`` does for card vs CPU): both sides then
    compute one function.  ``active(replay="count")`` counts and replays
    nothing; a routing of another shape than the record's counts every
    pair as flipped and is not replayed.  A rank holding G of the record's groups takes the
    ``offset``-th G of them (its data coordinate)."""

    def __init__(self, routers):
        self.routers = routers
        self.phase, self.offset = None, 0
        self.want, self.flips, self.pairs = {}, {}, {}

    def _layer(self, router) -> int:
        for i, r in enumerate(self.routers):
            if r.shape == router.shape and torch.equal(r, router):
                return i
        raise AssertionError("a router of no recorded layer")

    @contextlib.contextmanager
    def active(self, replay: bool):
        from repro_torch.models import moe
        route = moe.route

        def patched(router, xg, top_k, cf):
            r = route(router, xg, top_k, cf)
            key = (self.phase, self._layer(router))
            if not replay:
                if key in self.want:
                    assert torch.equal(self.want[key], r.idx), key
                else:
                    self.want[key] = r.idx
                return r
            want = self.want[key]
            g = xg.shape[0]
            off = 0 if g == want.shape[0] else self.offset * g
            want = want[off:off + g]
            if key not in self.flips:
                self.pairs[key] = want.numel()
                self.flips[key] = (int((r.idx != want).sum())
                                   if r.idx.shape == want.shape
                                   else want.numel())
            if replay == "count" or r.idx.shape != want.shape:
                return r
            vals = torch.gather(r.probs, -1, want)
            return r._replace(gates=vals / vals.sum(-1, keepdim=True),
                              idx=want)

        moe.route = patched
        try:
            yield
        finally:
            moe.route = route


def _family_pass(cfg, fns, params, routes, rules, *, grad_compress=False):
    """One process (``rules`` None, plain params) or the ranks (DTensor
    params): the loss and every gradient of ``family_batch``, the MoE
    balance term, one Adam step with clipping (``grad_compress``: int8
    error feedback) from the initial state, prefill and two decode steps'
    logits; every result gathered whole.  Returns (results, the stepped
    state, the gradients, the cache)."""
    from functools import partial

    from repro_torch.dist.sharding import distribute_tree, placed_like
    from repro_torch.launch.input_specs import batch_axes
    from repro_torch.optim import adam
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import leaves, rebuild

    def place(tree, axes):
        return tree if rules is None else distribute_tree(tree, axes, rules)

    def whole(t):
        return t if rules is None else t.full_tensor()

    batch = family_batch(cfg)
    seq = family_seq(cfg)
    terms, out = {}, {}
    loss_fn = partial(fns.loss, terms=terms) if cfg.family == "moe" \
        else fns.loss
    with routes.active(replay=rules is not None):
        routes.phase = "train"
        placed = place(batch, batch_axes(cfg))
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        loss = loss_fn(rebuild(params, live), placed)
        grads = [placed_like(g, p) for g, p in
                 zip(torch.autograd.grad(loss, live), live)]
        out["loss"] = whole(loss.detach())
        out["grads"] = [whole(g) for g in grads]
        if "balance" in terms:
            out["balance"] = whole(terms["balance"])
        opt = adam(LR)
        step = make_train_step(fns.loss, opt, max_grad_norm=1.0,
                               grad_compress=grad_compress)
        new, _ = step(init_train_state(params, opt,
                                       grad_compress=grad_compress), placed)
        out["new_params"] = [whole(t) for t in leaves(new.params)]
        with torch.no_grad():
            routes.phase = "prefill"
            prompt = {k: v for k, v in batch.items() if k != "labels"}
            cache, logits = fns.prefill(params, place(
                prompt, batch_axes(cfg, "prefill")))
            out["logits"] = [whole(logits)]
            for i, tok in enumerate(decode_tokens(cfg)):
                routes.phase = f"decode{i}"
                logits, cache = fns.decode(params, cache,
                                           place(tok, ("batch",)), seq + i)
                out["logits"].append(whole(logits))
    return out, new, grads, cache


def _moe_block_cases(cfg, layer, rules, routes_of) -> dict:
    """The MoE block alone on fixed bf16 inputs, one process and the mesh:
    y, the balance term, the gradients of x and of every param for a fixed
    cotangent, at a training shape (4 x 128 tokens, two groups), at one
    row of two groups (fewer rows than data ranks at (2, 2), as a
    microbatch of one row; placed replicated, since DTensor's products
    refuse a row split unevenly) and at a decode shape (16 x 1 tokens, one
    group spanning the batch) at capacity factor 0.5, so that its slots
    overflow and the choices dropped depend on the whole group's order."""
    from repro_torch.dist.sharding import distribute_tree, use_rules
    from repro_torch.models.common import COMPUTE
    from repro_torch.models.moe import moe_axes, moe_block
    from repro_torch.tree import leaves, rebuild

    axes = moe_axes(cfg.n_shared_experts, cfg.gated_mlp)
    res = {}
    for name, shape, cf, x_axes in (
            ("train", (GLOBAL_BATCH, MOE_SEQ), 1.25, ("batch", None, None)),
            ("one_row", (1, 4 * MOE_SEQ), 1.25, (None, None, None)),
            ("decode", (16, 1), 0.5, ("batch", None, None))):
        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.standard_normal(
            (*shape, cfg.d_model)).astype(np.float32)).to(COMPUTE)
        dy = torch.from_numpy(rng.standard_normal(
            (*shape, cfg.d_model)).astype(np.float32)).to(COMPUTE)
        routes = routes_of(layer)
        got = {}
        for side, ctx in (("ref", contextlib.nullcontext()),
                          ("mesh", use_rules(rules))):
            with ctx:
                p, xs, dys = layer, x, dy
                if side == "mesh":
                    p = distribute_tree(layer, axes, rules)
                    xs, dys = (distribute_tree(t, x_axes, rules)
                               for t in (x, dy))
                live = [t.detach().requires_grad_(True)
                        for t in [xs, *leaves(p)]]
                with routes.active(replay=side == "mesh" and "count"):
                    routes.phase = name
                    y, aux = moe_block(rebuild(p, live[1:]), live[0],
                                       top_k=cfg.top_k, capacity_factor=cf)
                    gs = torch.autograd.grad((y * dys).float().sum() + aux,
                                             live)
                whole = (lambda t: t) if side == "ref" else \
                    (lambda t: t.full_tensor())
                got[side] = {"y": whole(y.detach()),
                             "aux": whole(aux.detach()),
                             "grads": [whole(g) for g in gs]}
        res[name] = {**got, "flips": sum(routes.flips.values())}
    return res


def _expert_shards_ok(cfg, model, params, grads, new) -> bool:
    """Every rank's blocks of the experts' weights, their gradients and
    Adam's moments hold E / model experts, before and after the step."""
    from repro_torch.tree import leaves
    ids = {id(t) for lp in params["layers"]
           for t in (lp["moe"].w_gate, lp["moe"].w_in, lp["moe"].w_out)}
    idx = [i for i, t in enumerate(leaves(params)) if id(t) in ids]
    want = cfg.n_experts // model
    trees = [leaves(params), grads, leaves(new.params),
             leaves(new.opt_state.mu), leaves(new.opt_state.nu)]
    return len(idx) == 3 * cfg.n_layers and all(
        tree[i].to_local().shape[0] == want for tree in trees for i in idx)


def _all_ranks(flag: bool) -> bool:
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def _launch(argv) -> dict:
    """``launch.train.main(argv)``'s ``train_report``."""
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("train_report ")][-1]
    return json.loads(line[len("train_report "):])


def launch_argv(arch: str, out) -> list:
    """A family's smoke config through the launcher: ``LAUNCH_STEPS``
    steps of ``GLOBAL_BATCH`` x (128 for the MoE, else ``SEQ``) tokens."""
    from repro_torch.configs import get_smoke
    seq = MOE_SEQ if get_smoke(arch).family == "moe" else SEQ
    return ["--arch", arch, "--smoke", "--device", "cpu", "--steps",
            str(LAUNCH_STEPS), "--batch", str(GLOBAL_BATCH), "--seq",
            str(seq), "--ckpt-every", "0", "--ckpt-dir", str(out / arch)]


def job_families(rank, out, data, model, src=None):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.sharding import (axes_to_placements,
                                           distribute_tree, full_tree,
                                           layout_of, make_mesh, map_axes,
                                           use_rules, with_overrides)
    from repro_torch.ft.checkpoint import restore_state, save_state
    from repro_torch.ft.elastic import reshard_state
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import registry
    from repro_torch.optim import adam
    from repro_torch.optim.grad_compression import error_feedback_compress
    from repro_torch.train.step import init_train_state
    from repro_torch.tree import leaves, tree_map

    mesh = make_mesh((data, model), ("data", "model"), "cpu")
    rules = rules_for(mesh, global_batch=GLOBAL_BATCH)
    res = {}
    for arch in FAMILY_ARCHS:
        cfg = family_cfg(arch)
        fns = registry.build(cfg, model)
        params = fns.init(0, device="cpu")

        def routes_of(tree):
            layers = tree["layers"] if isinstance(tree, dict) else [
                {"moe": tree}]
            replay = RoutingReplay([lp["moe"].router for lp in layers])
            replay.offset = mesh.get_coordinate()[0]
            return replay

        moe = cfg.family == "moe"
        routes = routes_of(params) if moe else RoutingReplay([])
        ref, _, _, _ = _family_pass(cfg, fns, params, routes, None)
        compress = moe and data * model == 4  # --grad-compress on (2, 2)
        if compress:
            ref_c = _family_pass(cfg, fns, params, routes, None,
                                 grad_compress=True)[0]
        routes.offset = mesh.get_coordinate()[0]
        with use_rules(rules):
            dparams = distribute_tree(params, fns.param_axes(), rules)
            got, new, grads, cache = _family_pass(cfg, fns, dparams, routes,
                                                  rules)
            cache_ok = []
            map_axes(lambda ax, t: cache_ok.append(
                isinstance(t, DTensor) and tuple(t.placements)
                == axes_to_placements(ax, rules)),
                registry.cache_axes(cfg), cache)
            got["cache_placed_by_axes"] = all(cache_ok) and bool(cache_ok)
            got["grad_placements_match"] = all(
                tuple(g.placements) == tuple(p.placements)
                for g, p in zip(grads, leaves(dparams)))
            got["state_all_dtensor"] = all(isinstance(t, DTensor)
                                           for t in leaves(new))
            flips = [dict(routes.flips), dict(routes.pairs)]
            shares = [None] * dist.get_world_size()
            dist.all_gather_object(shares, flips)
            got["routing"] = shares
            if moe:
                got["experts_split"] = _all_ranks(_expert_shards_ok(
                    cfg, model, dparams, grads, new))
            if compress:
                got_c, new_c, grads_c, _ = _family_pass(
                    cfg, fns, dparams, routes, rules, grad_compress=True)
                comp, resid = error_feedback_compress(grads_c, None)
                want = error_feedback_compress([g.full_tensor()
                                                for g in grads_c], None)
                got["compress"] = {
                    "ref_params": ref_c["new_params"],
                    "new_params": got_c["new_params"],
                    "residual_placed_as_params": all(
                        isinstance(r, DTensor) and tuple(r.placements)
                        == tuple(p.placements) for r, p in
                        zip(leaves(new_c.ef_residual), leaves(dparams))),
                    "roundtrip_bit_equal": all(
                        torch.equal(a.full_tensor(), b)
                        for a, b in zip(comp + resid, want[0] + want[1]))}
                new = new_c
            if data * model == 4 and arch in ("deepseek-moe-16b",
                                               "seamless-m4t-large-v2"):
                save_state(new, out / f"ckpt-{arch}", 1, async_io=False)
                whole = full_tree(new)  # a collective: every rank
                if rank == 0:
                    torch.save(whole, out / f"ckpt-{arch}.pt")
            if src is not None and arch in ("deepseek-moe-16b",
                                             "seamless-m4t-large-v2"):
                src_fns = registry.build(cfg, 2)  # saved at model 2
                axes = src_fns.param_axes()
                like = init_train_state(
                    distribute_tree(src_fns.init(0, device="cpu"), axes,
                                    rules), adam(LR), grad_compress=moe)
                restored = restore_state(
                    like, src / f"ckpt-{arch}", device="cpu",
                    placements=tree_map(layout_of, like))
                want = torch.load(src / f"ckpt-{arch}.pt",
                                  weights_only=False)
                moved = reshard_state(restored.params, axes,
                                      with_overrides(rules, fsdp=None))
                lp = (moved["layers"] if moe else moved["dec"]["layers"])[0]
                probe = lp["moe"].w_gate if moe else lp["cross"].wq
                got["restore"] = {
                    "bit_equal": all(torch.equal(a, b) for a, b in zip(
                        leaves(full_tree(restored)), leaves(want))),
                    "all_dtensor": all(isinstance(t, DTensor)
                                       for t in leaves(restored)),
                    "resharded_bit_equal": all(
                        torch.equal(a, b) for a, b in zip(
                            leaves(full_tree(moved)), leaves(want.params))),
                    "resharded_placements": tuple(probe.placements) == (
                        (Replicate(), Shard(0)) if moe
                        else (Replicate(), Shard(1)))}
        if moe:  # one process's side without the ambient rules
            got["block"] = _moe_block_cases(
                cfg, params["layers"][0]["moe"], rules, routes_of)
        res[arch] = {"ref": ref, "mesh": got}
    if src is not None:  # every family through the launcher, (1, 2)
        res["launcher"] = {arch: _launch(launch_argv(arch, out)
                                         + ["--mesh", "single"])
                           for arch in FAMILY_ARCHS}
        res["launcher"]["compress"] = _launch(
            launch_argv("deepseek-moe-16b", out / "c")
            + ["--mesh", "single", "--grad-compress"])
    if data * model == 4:
        res["launcher_multi"] = _launch(
            launch_argv("mamba2-1.3b", out / "m")
            + ["--mesh", "multi", "--grad-compress"])
    return res


def job_world1(rank, out):
    """Every family, and the MoE with ``--grad-compress``, through the
    launcher with and without ``--mesh single`` on one rank."""
    runs = [(arch, []) for arch in FAMILY_ARCHS] + [
        ("deepseek-moe-16b", ["--grad-compress"])]
    res = []
    for arch, extra in runs:
        argv = launch_argv(arch, out / "none") + extra
        res.append((arch, extra, _launch(argv),
                    _launch(launch_argv(arch, out / "mesh") + extra
                            + ["--mesh", "single"])))
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
        elif job == "families":
            res = job_families(rank, out, data, model, pathlib.Path(argv[7])
                               if len(argv) > 7 else None)
        elif job == "world1":
            res = job_world1(rank, out)
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

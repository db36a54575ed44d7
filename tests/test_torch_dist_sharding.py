"""The port's distribution layer (``repro_torch.dist``, ``launch.mesh``,
``launch.input_specs``, ``ft.elastic``, head padding) against the JAX
package, and its own contracts.

* Pure logic, exactly: ``axes_to_placements`` against the reference's
  ``axes_to_spec`` for every rule set, ``rules_for`` and
  ``downsize_batch_rules`` on ``(data, model)`` and ``(pod, data, model)``
  meshes (the reference on ``jax.sharding.AbstractMesh``, the port on a
  stand-in that has its ``DeviceMesh``'s names and shape; both read only
  those), the survivors' layout held through the reference's
  ``downsize_batch_rules`` and ``rules_for`` and against the survivor
  meshes ``tests/test_chunked_training.py`` states, ``padded_heads`` / ``padded_vocab`` at tp 1, 2,
  4 and 16 for every arch, and every param and cache axes tree for every
  arch after the per-layer conversion ``convert.lm_params_from_numpy``
  applies to the weights.
* The ambient stack and ``shard``'s identity cases, case for case as
  ``tests/test_dist_sharding.py`` (the one-device mesh on a world-1 gloo
  group); the refusals under a larger mesh are held by
  ``tests/test_torch_dist_ranks.py``.
* tp > 1 numerics: the smoke tinyllama's params built by the JAX package
  at tp 2 and 4 (padded heads) and carried across by ``convert``: the
  port's prefill logits within 2 bf16 ulps of the largest, the loss at
  rtol 1e-4 and every gradient leaf within 8 bf16 ulps of its largest
  (the dense family's tolerances, ``test_torch_lm.py`` and
  ``test_torch_lm_train.py``).
* What the reference does with its fused Pallas training kernel under a
  mesh (a 4-device subprocess): it runs unsharded, on one device, the same
  bits as without the mesh — what the port's ``fused`` backend does on
  every rank.
* A DTensor reaching a kernel wrapper raises, naming ``local_map``.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.dist import sharding as jsh
from repro.ft.elastic import downsize_batch_rules as jdownsize
from repro.launch.mesh import rules_for as jrules_for
from repro.models import registry as jregistry
from repro_torch import configs as pconfigs
from repro_torch.configs.base import param_count
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist import sharding as psh
from repro_torch.ft import elastic as pelastic
from repro_torch.ft.checkpoint import restore_state, save_state
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.fused_train import kernel as train_kernel
from repro_torch.kernels.qat_dense import fused as fused_fwd
from repro_torch.kernels.qat_dense import kernel as qat_kernel
from repro_torch.launch import input_specs
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.mesh import rules_for as prules_for
from repro_torch.models import registry as pregistry
from repro_torch.tree import leaves, rebuild

ROOT = pathlib.Path(__file__).resolve().parents[1]
LM_ARCHS = [a for a in pconfigs.ARCHS
            if pconfigs.get_config(a).family != "mrf"]
RULE_SETS = {
    "single": (jsh.SINGLE_POD_RULES, psh.SINGLE_POD_RULES,
               ("data", "model")),
    "multi": (jsh.MULTI_POD_RULES, psh.MULTI_POD_RULES,
              ("pod", "data", "model")),
    "single-sp": (jsh.with_overrides(jsh.SINGLE_POD_RULES, act_seq="model"),
                  psh.with_overrides(psh.SINGLE_POD_RULES,
                                     act_seq="model"), ("data", "model")),
    "multi-degraded": (jsh.with_overrides(jsh.MULTI_POD_RULES, batch="data"),
                       psh.with_overrides(psh.MULTI_POD_RULES,
                                          batch="data"),
                       ("pod", "data", "model")),
    "replicated-batch": (jsh.with_overrides(jsh.SINGLE_POD_RULES, batch=None),
                         psh.with_overrides(psh.SINGLE_POD_RULES,
                                            batch=None), ("data", "model")),
}


def _mesh_stub(names, shape):
    """What the port's mesh functions read of a ``DeviceMesh``."""
    return types.SimpleNamespace(mesh_dim_names=tuple(names),
                                 shape=tuple(shape))


# --------------------------------------------------------------------------
# axes trees: every arch, after the per-layer conversion
# --------------------------------------------------------------------------

def _plain(tree):
    """Axes trees as dicts / lists / tuples (NamedTuples by field)."""
    if tree is None or psh.is_axes(tree):
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return [_plain(v) for v in tree]


def _per_layer(stacked, n: int) -> list:
    """A stacked layer's axes -> ``n`` layers' axes, the leading ``None``
    of every leaf dropped (``convert.lm_params_from_numpy``'s split)."""
    def drop(tree):
        if tree is None:
            return None
        if psh.is_axes(tree):
            assert tree[0] is None, tree
            return tree[1:]
        if isinstance(tree, dict):
            return {k: drop(v) for k, v in tree.items()}
        return [drop(v) for v in tree]
    return [drop(_plain(stacked)) for _ in range(n)]


def _converted_param_axes(cfg, jaxes):
    if cfg.family == "encdec":
        return {"enc": {"layers": _per_layer(jaxes["enc"]["layers"],
                                             cfg.n_enc_layers),
                        "norm": jaxes["enc"]["norm"]},
                "dec": {"embed": jaxes["dec"]["embed"],
                        "layers": _per_layer(jaxes["dec"]["layers"],
                                             cfg.n_layers),
                        "norm": jaxes["dec"]["norm"]},
                "head": jaxes["head"]}
    out = {**_plain(jaxes), "layers": _per_layer(jaxes["layers"],
                                                 cfg.n_layers)}
    if cfg.tie_embeddings:  # the embedding is the head (the reference's
        del out["head"]     # has one of its own)
    return out


@pytest.mark.parametrize("arch", sorted(pconfigs.ARCHS))
def test_param_axes_equal_the_reference_after_conversion(arch):
    jcfg, pcfg = jconfigs.get_config(arch), pconfigs.get_config(arch)
    jaxes = jregistry.build(jcfg).param_axes()
    paxes = pregistry.build(pcfg).param_axes()
    if pcfg.family == "mrf":
        assert _plain(paxes) == _plain(jaxes)
        return
    assert _plain(paxes) == _converted_param_axes(pcfg, jaxes)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_axes_equal_the_reference_after_conversion(arch):
    jcfg, pcfg = jconfigs.get_config(arch), pconfigs.get_config(arch)
    jaxes, paxes = jregistry.cache_axes(jcfg), pregistry.cache_axes(pcfg)
    if pcfg.family == "ssm":  # the reference stacks the per-layer caches
        assert _plain(paxes) == _per_layer(jaxes, pcfg.n_layers)
    else:
        assert _plain(paxes) == _plain(jaxes)
    with pytest.raises(NotImplementedError, match="no decode cache"):
        pregistry.cache_axes(pconfigs.get_config("mrf-fpga"))


@pytest.mark.parametrize("arch", sorted(pconfigs.ARCHS))
def test_axes_trees_mirror_the_port_trees(arch):
    """Every tensor of the params (and caches) has an axes tuple of its
    rank, at tp 1 and 2 (smoke sizes)."""
    cfg = pconfigs.get_smoke(arch)
    for tp in (1, 2):
        fns = pregistry.build(cfg, tp)
        trees = [(fns.init(0, device="meta") if cfg.family != "mrf"
                  else fns.init(torch.Generator().manual_seed(0)),
                  fns.param_axes())]
        if cfg.family != "mrf":
            trees.append((fns.init_cache(2, 16, device="meta"),
                          pregistry.cache_axes(cfg)))
        for tree, axes in trees:
            ranks = []
            psh.map_axes(lambda a, t: ranks.append((len(a), t.dim())),
                         axes, tree)
            assert ranks and all(a == d for a, d in ranks)
            assert len(ranks) == len(leaves(tree))


# --------------------------------------------------------------------------
# placements, rules_for, downsize
# --------------------------------------------------------------------------

def _axes_samples():
    """Every axes tuple of every arch's trees, and the activations'."""
    found = {("batch", "act_seq", None), ("batch", None, "tp", None),
             ("layers", "batch", "cache_seq", None, None), ("batch", "tp"),
             ("batch", "fsdp", "tp"), ("no_such_axis", "tp"), ()}
    for arch in pconfigs.ARCHS:
        cfg = pconfigs.get_config(arch)
        fns = pregistry.build(cfg)
        psh.map_axes(lambda a: found.add(a), fns.param_axes())
        if cfg.family != "mrf":
            psh.map_axes(lambda a: found.add(a), pregistry.cache_axes(cfg))
    return sorted(found, key=repr)


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_axes_to_placements_match_axes_to_spec(name):
    jrules, prules, mesh_dims = RULE_SETS[name]
    for axes in _axes_samples():
        spec = tuple(jsh.axes_to_spec(axes, jrules))
        owners = {}
        for i, entry in enumerate(spec):
            for m in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                owners.setdefault(m, []).append(i)
        if any(len(v) > 1 for v in owners.values()):
            with pytest.raises(ValueError, match="both map to mesh dim"):
                psh.axes_to_placements(axes, prules, mesh_dims)
            continue
        want = tuple(Shard(owners[m][0]) if m in owners else Replicate()
                     for m in mesh_dims)
        assert psh.axes_to_placements(axes, prules, mesh_dims) == want


def test_multi_pod_batch_shards_one_dim_over_pod_and_data():
    got = psh.axes_to_placements(("batch", None, "tp"), psh.MULTI_POD_RULES,
                                 ("pod", "data", "model"))
    assert got == (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="needs mesh dims"):
        psh.axes_to_placements(("batch",), psh.SINGLE_POD_RULES)


MESHES = [(("data", "model"), (16, 16)), (("data", "model"), (2, 2)),
          (("data", "model"), (1, 1)), (("pod", "data", "model"), (2, 16, 16)),
          (("pod", "data", "model"), (2, 2, 2))]


@pytest.mark.parametrize("names,shape", MESHES)
@pytest.mark.parametrize("sp", [False, True])
def test_rules_for_matches_the_reference(names, shape, sp):
    jmesh = jax.sharding.AbstractMesh(shape, names)
    pmesh = _mesh_stub(names, shape)
    for batch in (1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 256, 512):
        want = jrules_for(jmesh, global_batch=batch, sequence_parallel=sp)
        got = prules_for(pmesh, global_batch=batch, sequence_parallel=sp)
        assert dict(got.rules) == dict(want.rules), batch
        assert got.mesh is pmesh


def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", dict(out.rules), out.mesh)


@pytest.mark.parametrize("names,shape", MESHES)
def test_downsize_batch_rules_matches_the_reference(names, shape):
    jmesh = types.SimpleNamespace(shape=dict(zip(names, shape)))
    for jbase, pbase in ((jsh.SINGLE_POD_RULES, psh.SINGLE_POD_RULES),
                         (jsh.MULTI_POD_RULES, psh.MULTI_POD_RULES)):
        jr = jsh.AxisRules(rules=dict(jbase.rules), mesh=jmesh)
        pr = psh.AxisRules(rules=dict(pbase.rules),
                           mesh=_mesh_stub(names, shape))
        for lost in (-1, 0, 1, 2, 3, 4, 8, 15, 16, 32):
            for per in (1, 2):
                assert _outcome(pelastic.downsize_batch_rules, pr, lost,
                                per) == _outcome(jdownsize, jr, lost, per)
    with pytest.raises(ValueError, match="bound to the pre-eviction mesh"):
        pelastic.downsize_batch_rules(psh.SINGLE_POD_RULES, lost_hosts=1)


# The survivors' meshes that ``tests/test_chunked_training.py`` states for
# the reference: one data shard of (data 4, model 2) lost -> (data 3, model
# 2), a whole pod of (pod 2, data 2, model 2) lost -> (data 2, model 2)
# with the batch on "data", 5 survivors of (4, 2) refused; and two of the
# production shapes.  (pre-eviction dims, shape, rule set, live ranks,
# survivors' shape or None where refused.)
SURVIVOR_CASES = [
    (("data", "model"), (4, 2), "single", 6, (3, 2)),
    (("pod", "data", "model"), (2, 2, 2), "multi", 4, (2, 2)),
    (("data", "model"), (4, 2), "single", 5, None),
    (("data", "model"), (4, 2), "single", 0, None),
    (("data", "model"), (16, 16), "single", 128, (8, 16)),
    (("pod", "data", "model"), (2, 16, 16), "multi", 256, (16, 16)),
]
SURVIVOR_BATCH = 240  # divides every data extent above, before and after


@pytest.mark.parametrize("names,shape,rule_set,live,want", SURVIVOR_CASES)
def test_survivor_layout_matches_the_reference(names, shape, rule_set, live,
                                               want):
    """The survivors' layout held through the reference's
    ``downsize_batch_rules`` (the same eviction accepted or refused, a data
    shard spanning the ``model`` dim's ranks) and ``rules_for`` (the
    remapped rules equal the reference's bound to the survivors' mesh)."""
    jbase, pbase, _ = RULE_SETS[rule_set]
    jrules = jsh.AxisRules(rules=dict(jbase.rules), mesh=types.SimpleNamespace(
        shape=dict(zip(names, shape))))
    prules = psh.AxisRules(rules=dict(pbase.rules),
                           mesh=_mesh_stub(names, shape))
    per_shard = shape[-1]
    lost = int(np.prod(shape)) - live
    assert _outcome(pelastic.downsize_batch_rules, prules, lost, per_shard) \
        == _outcome(jdownsize, jrules, lost, per_shard)
    if want is None:
        with pytest.raises(ValueError):
            jdownsize(jrules, lost, per_shard)
        with pytest.raises(ValueError):
            pelastic.survivor_layout(live, prules)
        return
    assert jdownsize(jrules, lost, per_shard).mesh is None
    got_shape, got_names, got_rules = pelastic.survivor_layout(live, prules)
    assert (tuple(got_shape), tuple(got_names)) == (want, ("data", "model"))
    assert got_rules.mesh is None
    ref = jrules_for(jax.sharding.AbstractMesh(want, ("data", "model")),
                     global_batch=SURVIVOR_BATCH)
    assert dict(got_rules.rules) == dict(ref.rules)
    assert got_rules.rules["batch"] == got_rules.rules["fsdp"] == "data"


def test_survivor_layout_refuses_meshless_rules():
    with pytest.raises(ValueError, match="bound to the pre-eviction mesh"):
        pelastic.survivor_layout(4, psh.SINGLE_POD_RULES)
    with pytest.raises(ValueError, match="bound to the pre-eviction mesh"):
        jdownsize(jsh.SINGLE_POD_RULES, lost_hosts=4)


def test_production_shape():
    assert production_shape(1, 1) == ((1, 1), ("data", "model"))
    assert production_shape(16, 8) == ((2, 8), ("data", "model"))
    assert production_shape(32, 8, multi_pod=True) == (
        (2, 2, 8), ("pod", "data", "model"))
    for world, per, multi in ((6, 4, False), (8, 8, True), (0, 1, False)):
        with pytest.raises(ValueError):
            production_shape(world, per, multi_pod=multi)


# --------------------------------------------------------------------------
# head padding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(pconfigs.ARCHS))
def test_padded_heads_and_vocab_match_the_reference(arch):
    jcfg, pcfg = jconfigs.get_config(arch), pconfigs.get_config(arch)
    for tp in (1, 2, 4, 16):
        assert pcfg.padded_heads(tp) == tuple(jcfg.padded_heads(tp)), tp
        assert pcfg.padded_vocab(tp) == jcfg.padded_vocab(tp), tp


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_heads_pad_as_the_reference(arch):
    from repro.models import lm as jlm
    from repro_torch.models import lm as plm
    cfg = pconfigs.get_config(arch)
    for tp in (1, 2, 4, 16, 48):
        assert plm.ssm_heads(cfg, tp) == \
            getattr(jlm, "_ssm_heads")(jconfigs.get_config(arch), tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_param_shapes_at_tp_equal_the_reference(tp):
    """The port's init at tp builds the reference's padded shapes, the
    padded query heads zero."""
    for arch in ("tinyllama-1.1b", "hymba-1.5b", "seamless-m4t-large-v2"):
        jcfg, pcfg = jconfigs.get_smoke(arch), pconfigs.get_smoke(arch)
        jparams = jregistry.build(jcfg, tp).init(jax.random.PRNGKey(0))
        want = lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        got = pregistry.build(pcfg, tp).init(0, device="cpu")
        assert [t.shape for t in leaves(got)] == \
            [t.shape for t in leaves(want)]
    cfg = dataclasses.replace(pconfigs.get_smoke("tinyllama-1.1b"),
                              n_heads=3, n_kv_heads=1)
    attn = pregistry.build(cfg, tp).init(0, device="cpu")["layers"][0]["attn"]
    hq, hkv = cfg.padded_heads(tp)
    assert hq > 3 and not attn.wq[:, 3 * 16:].any() \
        and not attn.wo[3 * 16:].any() and attn.wq[:, :3 * 16].any()


def test_input_specs_are_meta_and_sized():
    cfg = pconfigs.get_config("tinyllama-1.1b")
    params = input_specs.params_specs(cfg, 4)
    assert all(t.device.type == "meta" for t in leaves(params))
    assert input_specs.tree_nbytes(params) == 4 * param_count(cfg)
    batch = input_specs.batch_specs(cfg, 8, 2048)
    assert batch["tokens"].shape == (8, 2048) and "labels" in batch
    assert set(input_specs.batch_axes(cfg)) == set(batch)
    assert "labels" not in input_specs.batch_specs(cfg, 8, 2048, "prefill")
    enc = pconfigs.get_config("seamless-m4t-large-v2")
    assert input_specs.batch_axes(enc)["frames"] == ("batch", "act_seq", None)
    dec = input_specs.decode_specs(cfg, 8, 2048, 2)
    assert dec["cache"]["k"].shape == (22, 8, 2048, 4, 64)
    assert input_specs.decode_axes(cfg)["tokens"] == ("batch",)


# --------------------------------------------------------------------------
# the ambient stack and shard's identity cases
# --------------------------------------------------------------------------

def test_is_axes_leaf_predicate():
    from repro_torch.models.ssm import Mamba2Cache
    assert psh.is_axes(()) and psh.is_axes((None,))
    assert psh.is_axes(("batch", None, "tp"))
    assert not psh.is_axes(Mamba2Cache(("a",), ("b",), ("c",), ("d",)))
    for bad in (("batch", 3), (("batch",),), ({"k": 1},), ["batch"], "batch",
                types.SimpleNamespace()):
        assert not psh.is_axes(bad)


def test_with_overrides_does_not_mutate_input():
    base = psh.SINGLE_POD_RULES
    before = dict(base.rules)
    derived = psh.with_overrides(base, batch=None, act_seq="model")
    assert dict(base.rules) == before and derived.mesh is base.mesh
    assert derived.rules["batch"] is None and derived.rules["tp"] == "model"


def test_use_rules_nests_restores_and_is_reusable():
    assert psh.current_rules() is None
    outer = psh.SINGLE_POD_RULES
    inner = psh.with_overrides(outer, batch=None)
    with psh.use_rules(outer):
        assert psh.current_rules() is outer
        with psh.use_rules(inner):
            assert psh.current_rules() is inner
        assert psh.current_rules() is outer
    assert psh.current_rules() is None
    with pytest.raises(RuntimeError):
        with psh.use_rules(outer):
            raise RuntimeError("boom")
    assert psh.current_rules() is None
    ctx = psh.use_rules(outer)
    for _ in range(2):
        with ctx:
            assert psh.current_rules() is outer
        assert psh.current_rules() is None


@pytest.fixture
def one_rank(tmp_path):
    """A world-1 gloo process group (a ``file://`` store under tmp_path)
    and its ``(data=1, model=1)`` mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield psh.make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_shard_identity_cases(one_rank):
    x = torch.ones(4, 4)
    assert psh.shard(x, "batch", "tp") is x  # outside any scope
    with psh.use_rules(psh.SINGLE_POD_RULES):  # mesh-less rules
        assert psh.shard(x, "batch", "tp") is x
    rules = psh.AxisRules(rules=dict(psh.SINGLE_POD_RULES.rules),
                          mesh=one_rank)
    with psh.use_rules(rules):  # a one-device mesh
        assert psh.shard(x, "batch", "tp") is x


def test_param_placements_and_distribute_tree(one_rank):
    from repro_torch.models.ssm import Mamba2Cache
    with pytest.raises(ValueError, match="mesh-bound"):
        psh.param_placements({"w": ("fsdp", "tp")}, psh.SINGLE_POD_RULES)
    rules = psh.AxisRules(rules=dict(psh.SINGLE_POD_RULES.rules),
                          mesh=one_rank)
    tree = {"w": ("fsdp", "tp"), "scalar": (),
            "cache": Mamba2Cache(("batch", "tp"), ("batch", None), (None,),
                                 ())}
    out = psh.param_placements(tree, rules)
    assert out["w"].placements == (Shard(0), Shard(1))
    assert out["scalar"].placements == (Replicate(), Replicate())
    assert isinstance(out["cache"], Mamba2Cache)
    assert out["cache"].state.placements == (Shard(0), Shard(1))
    assert out["w"].mesh is one_rank
    values = {"w": torch.arange(6.).view(2, 3), "scalar": torch.tensor(2.),
              "cache": Mamba2Cache(torch.ones(2, 2), torch.ones(2, 2),
                                   torch.ones(2), torch.tensor(1.))}
    placed = psh.distribute_tree(values, tree, rules)
    assert placed["w"].placements == (Shard(0), Shard(1))
    assert torch.equal(psh.full_tree(placed)["w"], values["w"])


def test_one_device_mesh_changes_no_bit(one_rank):
    """The smoke tinyllama's loss and gradients with DTensor params on the
    (1, 1) mesh under its rules (B6 in ``local_map``) are the mesh-less
    bits: what phase 4k holds on the card at full width."""
    cfg = pconfigs.get_smoke("tinyllama-1.1b")
    fns = pregistry.build(cfg)
    params = fns.init(0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (2, 32))).long()
             for k in ("tokens", "labels")}

    def grads(p, b):
        live = [t.detach().requires_grad_(True) for t in leaves(p)]
        loss = fns.loss(rebuild(p, live), b)
        return [loss] + list(torch.autograd.grad(loss, live))

    want = grads(params, batch)
    rules = prules_for(one_rank, global_batch=2)
    with psh.use_rules(rules):
        got = grads(psh.distribute_tree(params, fns.param_axes(), rules),
                    psh.distribute_tree(batch, input_specs.batch_axes(cfg),
                                        rules))
    assert all(torch.equal(g.full_tensor(), w) for g, w in zip(got, want))


def test_meshless_checkpoint_round_trip_is_unchanged(tmp_path):
    """Without DTensors a checkpoint still holds one file a leaf."""
    tree = {"a": torch.arange(5.), "b": [torch.ones(2, 2), None]}
    save_state(tree, tmp_path, 3, async_io=False)()
    assert (tmp_path / "step_3" / "leaf_0.npy").exists()
    back = restore_state(tree, tmp_path, device="cpu")
    assert torch.equal(back["a"], tree["a"]) and back["b"][1] is None


# --------------------------------------------------------------------------
# kernels refuse DTensors
# --------------------------------------------------------------------------

def test_kernel_wrappers_refuse_a_dtensor(one_rank):
    from torch.distributed.tensor import distribute_tensor
    rep = [Replicate(), Replicate()]
    d3 = distribute_tensor(torch.zeros(2, 8, 16), one_rank, rep)
    d2 = distribute_tensor(torch.zeros(8, 64), one_rank, rep)
    calls = [
        lambda: flash_kernel.flash_attention_call(d3, d3, d3),
        lambda: flash_kernel.flash_attention_bwd_call(d3, d3, d3, d3, d3,
                                                      d3),
        lambda: qat_kernel.qat_dense_call(d2, d2, d2, d2),
        lambda: fused_fwd.fused_forward_call(d2, None),
        lambda: train_kernel.run_fused_train(d2, d2, d2, (64, 2), lr=0.1,
                                             tile_batch=8),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="local_map"):
            call()


# --------------------------------------------------------------------------
# tp > 1 numerics against the reference
# --------------------------------------------------------------------------

def _bf16_ulp(x) -> float:
    m = float(np.abs(np.asarray(x, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_padded_tinyllama_matches_the_reference(tp):
    jcfg = jconfigs.get_smoke("tinyllama-1.1b")
    jfns = jregistry.build(jcfg, tp)
    pfns = pregistry.build(pconfigs.get_smoke("tinyllama-1.1b"), tp)
    jparams = jfns.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    labs = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    labs[0, :4] = -1
    _, jlogits = jax.jit(jfns.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        _, plogits = pfns.prefill(params,
                                  {"tokens": torch.from_numpy(toks).long()})
    want = np.asarray(jlogits.astype(jnp.float32))
    assert float(np.abs(plogits.float().numpy() - want).max()) <= \
        2 * _bf16_ulp(want)
    jl, jg = jax.jit(jax.value_and_grad(jfns.loss))(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    live = [t.detach().requires_grad_(True) for t in leaves(params)]
    pl = pfns.loss(rebuild(params, live),
                   {"tokens": torch.from_numpy(toks).long(),
                    "labels": torch.from_numpy(labs).long()})
    pg = torch.autograd.grad(pl, live)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-4)
    wg = leaves(lm_params_from_numpy(jax.tree.map(np.asarray, jg),
                                     device="cpu"))
    for got, w in zip(pg, wg):
        assert float((got - w).abs().max()) <= 8 * _bf16_ulp(w.numpy())


# --------------------------------------------------------------------------
# the reference's fused kernel under a mesh
# --------------------------------------------------------------------------

_REF_FUSED = textwrap.dedent("""
    import os, json, tempfile
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys; sys.path.insert(0, "src")
    import contextlib
    import jax, numpy as np
    from repro.configs import get_smoke
    from repro.dist.sharding import make_compat_mesh, use_rules
    from repro.ft.runner import RunnerConfig
    from repro.launch.mesh import rules_for
    from repro.models import registry
    from repro.train import engine

    cfg = get_smoke("mrf-fpga")

    def run(rules):
        ecfg = engine.EngineConfig(backend="fused-pallas", lr=1e-3,
                                   optimizer="sgd", tile_batch=64,
                                   interpret=True)
        rcfg = RunnerConfig(total_steps=2, ckpt_dir=tempfile.mkdtemp(),
                            ckpt_every=100)
        ctx = contextlib.nullcontext() if rules is None else use_rules(rules)
        with ctx:
            state, _, _ = engine.train(registry.build(cfg), ecfg, rcfg,
                                       batch_size=128)
        ls = jax.tree.leaves(state.params)
        return ([np.asarray(x) for x in ls],
                max(len(x.sharding.device_set) for x in ls))

    mesh = make_compat_mesh((4, 1), ("data", "model"))
    plain, n_plain = run(None)
    meshed, n_mesh = run(rules_for(mesh, global_batch=128))
    print(json.dumps({"equal": all(np.array_equal(a, b)
                                   for a, b in zip(plain, meshed)),
                      "devices": [n_plain, n_mesh]}))
""")


def test_reference_runs_its_fused_kernel_unsharded_under_a_mesh():
    """Under a 4-device mesh's rules the reference's ``fused-pallas``
    backend trains on one device, the bits of its mesh-less run: its
    ``pallas_call`` has no sharding rule and nothing places the batch.
    The port's ``fused`` does the same on every rank (the whole batch,
    replicated params; ``test_torch_dist_ranks.py``)."""
    res = subprocess.run([sys.executable, "-c", _REF_FUSED], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"equal": True, "devices": [1, 1]}


def test_launcher_mesh_refusals(monkeypatch):
    """``--mesh`` without a process group raises, for every family and
    beside ``--grad-compress`` too (each family runs under the mesh:
    ``test_torch_dist_families.py``); ``--device cuda`` without a card
    raises before any of it."""
    from repro_torch.launch import train
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    base = ["--smoke", "--device", "cpu", "--steps", "1", "--ckpt-every",
            "0", "--mesh", "single"]
    with pytest.raises(RuntimeError, match="needs a process group"):
        train.main(["--arch", "tinyllama-1.1b", "--seq", "16", *base])
    with pytest.raises(RuntimeError, match="needs a process group"):
        train.main(["--arch", "mrf-fpga", "--batch", "128", *base])
    with pytest.raises(RuntimeError, match="needs a process group"):
        train.main(["--arch", "tinyllama-1.1b", "--grad-compress", *base])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", "tinyllama-1.1b", "--smoke", "--mesh",
                        "single"])


def test_no_stale_context():
    """Nothing above leaves ambient rules or a process group behind."""
    assert psh.current_rules() is None and not dist.is_initialized()

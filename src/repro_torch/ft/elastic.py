"""Elastic scaling: a training state re-placed onto another mesh
(counterpart of ``repro.ft.elastic``).

Checkpoints carry each piece's global index (``ft/checkpoint.py``), so
scaling between restarts is a restore with new placements.  Within a job,
:func:`reshard_state` re-places every leaf under new rules; the logical
axes are mesh-independent, which is what makes a state portable across
mesh shapes.  The reference's ``reshard_tree`` and ``survivor_mesh`` are
on its dead-exports allowlist, so the port names them :func:`reshard_state`
and :func:`survivor_rules`.
"""

from __future__ import annotations

import math

from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.dist.sharding import (AxisRules, make_mesh, map_axes,
                                       mesh_dim_sizes, param_placements)


def reshard_state(tree, axes_tree, new_rules: AxisRules):
    """``tree`` (DTensors or plain tensors) placed onto the mesh and rules
    of ``new_rules``, leaf by leaf as ``axes_tree`` names them.  On the
    same mesh a DTensor is redistributed; onto another it is gathered whole
    (every rank of its old mesh takes part) and distributed anew."""
    layouts = param_placements(axes_tree, new_rules)

    def one(_, t, lay):
        if t is None:
            return None
        if isinstance(t, DTensor):
            if t.device_mesh == lay.mesh:
                return t.redistribute(lay.mesh, lay.placements)
            t = t.full_tensor()
        return distribute_tensor(t, lay.mesh, lay.placements,
                                 src_data_rank=None)

    return map_axes(one, axes_tree, tree, layouts)


def _batch_dims(rules: AxisRules) -> tuple:
    dims = rules.rules.get("batch") or ("data",)
    return (dims,) if isinstance(dims, str) else tuple(dims)


def downsize_batch_rules(rules: AxisRules, lost_hosts: int,
                         hosts_per_data_shard: int = 1) -> AxisRules:
    """Policy helper: after evicting hosts, shrink the batch dims and keep
    the model dim (the tp degree is baked into the padded head counts).

    Checks that the eviction removes whole batch shards and leaves the
    pool non-empty — the pool is the product of the mesh dims the
    ``batch`` rule names (``data``; ``pod x data`` multi-pod, so losing a
    whole pod is valid) — then returns the mapping detached from the dead
    mesh, for ``launch.mesh.rules_for`` to bind to the survivors'."""
    if rules.mesh is None:
        raise ValueError("rules must be bound to the pre-eviction mesh")
    if lost_hosts <= 0:
        raise ValueError(f"lost_hosts must be positive, got {lost_hosts}")
    if lost_hosts % hosts_per_data_shard != 0:
        raise ValueError(
            f"evicting {lost_hosts} hosts is not shard-aligned "
            f"({hosts_per_data_shard} hosts per data shard): a surviving "
            f"data shard would straddle a dead host")
    lost_shards = lost_hosts // hosts_per_data_shard
    dims = _batch_dims(rules)
    sizes = mesh_dim_sizes(rules.mesh)
    pool = math.prod(sizes.get(a, 1) for a in dims)
    if lost_shards >= pool:
        raise ValueError(
            f"evicting {lost_shards} batch shards empties the batch-shard "
            f"pool ({'x'.join(dims)} had {pool})")
    return AxisRules(rules=dict(rules.rules), mesh=None)


def survivor_layout(n_live: int, rules: AxisRules) -> tuple:
    """(shape, dim names, remapped rules without a mesh) of the mesh the
    survivors form: every non-batch dim keeps its extent (the model dim
    intact), the batch dims (``data``; ``pod x data``) collapse into one
    ``data`` dim of whatever size the survivors tile, and every logical
    axis that named a batch dim (``batch``, ``fsdp``) maps to that
    ``data`` dim; the rest keep their mapping."""
    if rules.mesh is None:
        raise ValueError("rules must be bound to the pre-eviction mesh")
    if n_live <= 0:
        raise ValueError("no live ranks to build a survivor mesh from")
    dims = _batch_dims(rules)
    sizes = mesh_dim_sizes(rules.mesh)
    keep = [a for a in sizes if a not in dims]
    if "data" in keep:
        raise ValueError(
            f"batch rule {dims} does not cover the 'data' mesh dim; the "
            f"survivor mesh reserves 'data' for the collapsed batch dims")
    extent = math.prod(sizes[a] for a in keep)
    if n_live % extent != 0:
        raise ValueError(
            f"{n_live} survivors do not tile the intact "
            f"{'x'.join(keep) or '(none)'} extent {extent}: the eviction "
            f"must remove whole batch shards (check the plan with "
            f"downsize_batch_rules first)")
    remapped = {}
    for name, phys in rules.rules.items():
        phys_dims = (phys,) if isinstance(phys, str) else (phys or ())
        remapped[name] = "data" if any(a in dims for a in phys_dims) \
            else phys
    return ((n_live // extent, *(sizes[a] for a in keep)),
            ("data", *keep), AxisRules(rules=remapped))


def survivor_rules(live_ranks, rules: AxisRules, device_type="cuda"
                   ) -> AxisRules:
    """The survivors' mesh (:func:`survivor_layout`) built and bound: the
    reference's ``survivor_mesh``.  ``live_ranks`` must be the default
    process group's ranks (a job restarted on the survivors: its world is
    them)."""
    import torch.distributed as dist
    live = list(live_ranks)
    if len(set(live)) != len(live):
        raise ValueError("live_ranks contains duplicates")
    shape, names, remapped = survivor_layout(len(live), rules)
    if sorted(live) != list(range(dist.get_world_size())):
        raise ValueError(f"the survivors {live} must be the process group's "
                         f"ranks 0..{dist.get_world_size() - 1}: restart "
                         f"the job on them")
    return AxisRules(rules=remapped.rules,
                     mesh=make_mesh(shape, names, device_type))

"""Production mesh construction (counterpart of ``repro.launch.mesh``).

Topology (H100 nodes, the counterpart of the reference's v5e pods):
  single : (data=nodes, model=cards per node) — the ``model`` dim stays
           inside one node's NVLink domain (tensor parallelism's
           all-reduces), ``data`` runs across nodes.
  multi  : (pod=2, data=nodes/2, model=cards per node) — ``pod`` crosses
           the multi-pod boundary; only data parallelism (the gradient
           reduction) crosses it.

The world is the process group's (``torchrun`` sets ``WORLD_SIZE`` and
``LOCAL_WORLD_SIZE``), never a constant: one card under ``torchrun
--nproc-per-node 1`` is the ``(data=1, model=1)`` mesh.  A world that does
not tile the mesh raises.
"""

from __future__ import annotations

import math
import os

from repro_torch.dist.sharding import (MULTI_POD_RULES, SINGLE_POD_RULES,
                                       AxisRules, make_mesh, mesh_dim_sizes)


def production_shape(world: int, per_node: int, *, multi_pod: bool = False
                     ) -> tuple:
    """(shape, dim names) of the production mesh for ``world`` ranks,
    ``per_node`` of them on each node."""
    if per_node < 1 or world < 1 or world % per_node:
        raise ValueError(f"a world of {world} ranks does not tile nodes of "
                         f"{per_node} cards")
    nodes = world // per_node
    if not multi_pod:
        return (nodes, per_node), ("data", "model")
    if nodes % 2:
        raise ValueError(f"a multi-pod mesh needs an even number of nodes; "
                         f"the world has {nodes}")
    return (2, nodes // 2, per_node), ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production mesh over the default process group's ranks."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs a process group "
                           "(run under torchrun)")
    world = dist.get_world_size()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    shape, names = production_shape(world, per_node, multi_pod=multi_pod)
    return make_mesh(shape, names, device_type)


def rules_for(mesh, *, global_batch: int,
              sequence_parallel: bool = False) -> AxisRules:
    """Axis rules bound to ``mesh``, the batch's sharding degraded when the
    global batch does not divide the batch dims (the reference's logic):
    multi-pod falls back to ``data`` alone, then to replicated."""
    sizes = mesh_dim_sizes(mesh)
    multi = "pod" in sizes
    base = MULTI_POD_RULES if multi else SINGLE_POD_RULES
    batch_dims = ("pod", "data") if multi else ("data",)
    denom = math.prod(sizes[a] for a in batch_dims)
    overrides = {}
    if global_batch % denom != 0:
        if multi and global_batch % sizes["data"] == 0:
            overrides["batch"] = "data"
        else:
            overrides["batch"] = None
    if sequence_parallel:
        overrides["act_seq"] = "model"
    return AxisRules(rules={**base.rules, **overrides}, mesh=mesh)

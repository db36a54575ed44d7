"""Logical-axis distribution layer on a torch ``DeviceMesh`` (counterpart
of ``repro.dist.sharding``).

Contract
--------
Model code never names mesh dims.  It names *logical* axes — ``"batch"``,
``"fsdp"``, ``"tp"``, ``"layers"``, ``"act_seq"``, ``"cache_seq"`` — and an
:class:`AxisRules` maps each logical name to a mesh dim (a ``str``), a
tuple of mesh dims (the tensor dim is sharded over their product, e.g. the
multi-pod batch over ``("pod", "data")``), or ``None`` (replicated).
Logical names absent from the mapping are replicated, so model code may
annotate axes that only some topologies shard (``"cache_seq"``).

Placement is DTensor's (``torch.distributed.tensor``): a logical-axes
tuple becomes one placement per mesh dim (:func:`axes_to_placements`),
``Shard(tensor_dim)`` where a tensor dim maps to that mesh dim and
``Replicate()`` elsewhere.

- :data:`SINGLE_POD_RULES` / :data:`MULTI_POD_RULES`: the production
  mappings (``launch/mesh.py`` builds the meshes).
- :func:`is_axes`: the leaf predicate of axes trees (plain tuples only;
  NamedTuples are containers), so an axes tree mirrors its param tree.
- :func:`use_rules` / :func:`current_rules`: the ambient rules, a stack;
  the innermost wins and an exception restores the outer rules.
- :func:`shard`: the identity with no ambient rules, mesh-less rules, a
  one-device mesh or a fully replicated result, as in the reference.
  Otherwise a DTensor is redistributed to the placements its axes imply,
  and a plain tensor **raises**: a local tensor with no stated placement
  never enters a sharded region silently.
- :func:`param_placements` / :func:`distribute_tree`: an axes tree ->
  a :class:`Layout` tree, and a tensor tree placed by one.
- :func:`replicated_like` states a constant's placement (a RoPE table, a
  mask made from ``arange``) next to a DTensor it meets; DTensor refuses to
  mix the two otherwise.
- :func:`rules_placements` / :func:`grad_placements`: where a block run
  per rank in ``local_map`` takes its inputs (the ambient rules on the
  block's mesh), and where their gradients come back from it.
- :func:`make_mesh`: every mesh of the port comes from here
  (``init_device_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

#: what a logical axis maps to: one mesh dim, several (the tensor dim is
#: sharded over their product), or None (replicated)
MeshDims = Any  # str | tuple[str, ...] | None


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """A logical -> mesh-dim mapping, optionally bound to a ``DeviceMesh``.

    The module constants are mesh-less mappings; ``launch.mesh.rules_for``
    binds one to a live mesh.  Frozen: derive variants with
    :func:`with_overrides`."""

    rules: Mapping[str, MeshDims]
    mesh: Any = None  # torch.distributed.device_mesh.DeviceMesh | None


SINGLE_POD_RULES = AxisRules(rules={
    "batch": "data",      # data parallelism
    "fsdp": "data",       # ZeRO-3 style param/optimizer sharding, same dim
    "tp": "model",        # tensor parallelism (heads / ff / vocab / experts)
    "layers": None,       # layer stacks stay replicated over L
    "act_seq": None,      # the sequence stays local unless sequence_parallel
})

# Multi-pod: the batch also shards over the "pod" dim (the gradient
# reduction is the only cross-pod collective); the rest as single-pod.
MULTI_POD_RULES = AxisRules(rules={
    **SINGLE_POD_RULES.rules,
    "batch": ("pod", "data"),
})


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a tensor lives: a mesh and one placement per mesh dim (the
    reference's ``NamedSharding``)."""

    mesh: Any
    placements: tuple


def is_axes(obj) -> bool:
    """True exactly for *plain* tuples whose members are all ``str`` or
    ``None``, the empty tuple included (a scalar's axes).  NamedTuples are
    containers (``type(obj) is tuple`` excludes them)."""
    return type(obj) is tuple and all(
        a is None or isinstance(a, str) for a in obj)


def mesh_dim_sizes(mesh) -> dict:
    """``{mesh dim name: size}`` of a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and a ``shape`` tuple)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_size(mesh) -> int:
    n = 1
    for s in tuple(mesh.shape):
        n *= s
    return n


def _mesh_dims_of(entry: MeshDims) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_to_placements(axes: Sequence[str | None], rules: AxisRules,
                       mesh_dims: Sequence[str] | None = None) -> tuple:
    """One placement per mesh dim (``mesh_dims``, default the rules' mesh's
    names): ``Shard(i)`` where tensor dim ``i``'s logical axis maps to that
    mesh dim, ``Replicate()`` elsewhere.  ``None`` entries and names absent
    from the mapping are replicated.  Two tensor dims on one mesh dim
    raise (the reference's ``PartitionSpec`` cannot hold that either)."""
    if mesh_dims is None:
        if rules.mesh is None:
            raise ValueError("axes_to_placements needs mesh dims: bind the "
                             "rules to a mesh (launch.mesh.rules_for) or "
                             "pass mesh_dims")
        mesh_dims = rules.mesh.mesh_dim_names
    owner: dict = {}
    for i, a in enumerate(axes):
        for m in _mesh_dims_of(None if a is None else rules.rules.get(a)):
            if m in owner:
                raise ValueError(f"axes {tuple(axes)}: tensor dims {owner[m]} "
                                 f"and {i} both map to mesh dim {m!r}")
            owner[m] = i
    return tuple(Shard(owner[m]) if m in owner else Replicate()
                 for m in mesh_dims)


def with_overrides(rules: AxisRules, **overrides: MeshDims) -> AxisRules:
    """A new AxisRules with some logical axes remapped; the input (often a
    shared module constant) is not mutated."""
    return AxisRules(rules={**rules.rules, **overrides}, mesh=rules.mesh)


# --------------------------------------------------------------------------
# ambient rules
# --------------------------------------------------------------------------

_AMBIENT: list = []


def current_rules() -> AxisRules | None:
    """The innermost ambient rules, or None outside any ``use_rules``."""
    return _AMBIENT[-1] if _AMBIENT else None


class use_rules:
    """Context manager installing ``rules`` as the ambient rule set:
    nestable, each exit pops exactly one frame (on exceptions too), and an
    instance may be built early and entered more than once."""

    def __init__(self, rules: AxisRules):
        self._rules = rules

    def __enter__(self) -> AxisRules:
        _AMBIENT.append(self._rules)
        return self._rules

    def __exit__(self, exc_type, exc, tb) -> bool:
        _AMBIENT.pop()
        return False


def shard(x, *logical_axes: str | None):
    """``x`` placed as its logical axes imply under the ambient rules.

    The identity with no ambient rules, rules without a mesh, a one-device
    mesh, or placements that come out fully replicated (the reference's
    cases).  Otherwise a DTensor is redistributed (a no-op when it is
    placed so already) and a plain tensor raises."""
    rules = current_rules()
    if rules is None or rules.mesh is None or mesh_size(rules.mesh) <= 1:
        return x
    placements = axes_to_placements(logical_axes, rules)
    if all(isinstance(p, Replicate) for p in placements):
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            f"shard{tuple(logical_axes)}: a plain {type(x).__name__} under "
            f"a mesh of {mesh_size(rules.mesh)} devices; place it first "
            f"(distribute_tree, or DTensor.from_local with its placements)")
    if tuple(x.placements) == placements and x.device_mesh == rules.mesh:
        return x
    return x.redistribute(rules.mesh, placements)


def replicated_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor (every rank computed the same ``t``), else ``t`` itself."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def placed_like(t, ref):
    """``t`` redistributed to ``ref``'s placements (a gradient onto its
    parameter's: the data-parallel reduction made explicit); the identity
    for plain tensors and for placements that already agree."""
    if not isinstance(t, DTensor) or not isinstance(ref, DTensor):
        return t
    if tuple(t.placements) == tuple(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def rules_placements(axes: Sequence[str | None], ref) -> tuple:
    """The placements ``axes`` imply under the ambient rules on ``ref``'s
    mesh (a DTensor's): where a block run per rank in ``local_map`` takes
    its inputs.  Raises without ambient rules bound to that mesh: the
    block's placements are the rules', never guessed."""
    rules = current_rules()
    if rules is None or rules.mesh != ref.device_mesh:
        raise ValueError(
            f"placing {tuple(axes)} per rank needs the ambient rules of the "
            f"tensor's mesh (use_rules(launch.mesh.rules_for(mesh, ...)))")
    return axes_to_placements(axes, rules)


def grad_placements(in_placements: Sequence, *out_placements) -> list:
    """Where the gradient of a ``local_map`` input placed by
    ``in_placements`` comes back, the block's outputs placed by
    ``out_placements``: ``Partial()`` on each mesh dim over which an output
    is split (``Shard``, or ``Partial``) while the input is replicated —
    each rank then holds only its share of the input's gradient, the sum of
    the ranks' is the whole —, the input's own placement elsewhere."""
    split = {i for out in out_placements for i, p in enumerate(out)
             if isinstance(p, (Shard, Partial))}
    return [Partial() if i in split and isinstance(p, Replicate) else p
            for i, p in enumerate(in_placements)]


class _GradPlacedAsInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, target):
        ctx.mesh = x.device_mesh
        ctx.placements = target or tuple(
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements)
        ctx.always = target is not None
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if (ctx.always and tuple(g.placements) != ctx.placements) or any(
                isinstance(p, Partial) for p in g.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None


def grad_placed_as(x, placements=None):
    """``x`` (the identity in the forward) whose gradient, where it comes
    back with pending sums, is redistributed to ``x``'s own placements (a
    pending ``x`` to replicated): the shares of the gradient that the
    tensor-parallel products reading ``x`` leave on each ``model`` rank
    are reduced there, as Megatron reduces a column-parallel input's
    gradient and GSPMD places it in the reference.  Left pending, DTensor
    carries the pending sum into the ops before and runs their backward
    products at full width.  With ``placements`` the gradient is always
    redistributed to them (the SSM gate's, ``models.ssm.ssm_block``).
    The identity for a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    return _GradPlacedAsInput.apply(
        x, None if placements is None else tuple(placements))


def local_block(shape, mesh, placements) -> tuple:
    """(local shape, global offset) of this rank's block of a tensor of
    ``shape`` placed by ``placements`` on ``mesh``, as ints (DTensor's
    helper; the dry-run runs it outside its fake mode,
    ``launch.dryrun.dtensor_metadata_outside_fake``)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, offset = compute_local_shape_and_global_offset(shape, mesh,
                                                          placements)
    return tuple(local), tuple(int(o) for o in offset)


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------

def layout_of(t):
    """A DTensor's :class:`Layout`; ``None`` for a plain tensor."""
    if not isinstance(t, DTensor):
        return None
    return Layout(t.device_mesh, tuple(t.placements))


def map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree (leaves by :func:`is_axes`,
    containers dicts, lists, tuples and NamedTuples, ``None`` kept) and
    trees of the same structure."""
    if axes_tree is None:
        return None
    if is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], *(t[k] for t in trees))
                for k in axes_tree}
    if isinstance(axes_tree, (list, tuple)):
        subs = [map_axes(fn, *group) for group in zip(axes_tree, *trees)]
        if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*subs)
        return type(axes_tree)(subs)
    raise TypeError(f"axes tree leaf {axes_tree!r} is not a logical-axes "
                    f"tuple")


def param_placements(axes_tree, rules: AxisRules):
    """An axes tree -> a :class:`Layout` tree, leaf for leaf (the
    reference's ``param_shardings``); the rules must be bound to a mesh."""
    if rules.mesh is None:
        raise ValueError(
            "param_placements needs mesh-bound rules; bind the mapping with "
            "launch.mesh.rules_for(mesh, ...) first")
    return map_axes(lambda axes: Layout(rules.mesh,
                                        axes_to_placements(axes, rules)),
                    axes_tree)


def distribute_tree(tree, axes_tree, rules: AxisRules):
    """``tree`` (params, an optimizer state, a cache) as DTensors placed by
    ``axes_tree`` under ``rules``.  Every rank holds the same full tensors
    (drawn from the same seed) and keeps its own pieces: no collective."""
    layouts = param_placements(axes_tree, rules)
    return map_axes(lambda _, t, lay: None if t is None else distribute_tensor(
        t, lay.mesh, lay.placements, src_data_rank=None),
        axes_tree, tree, layouts)


def full_tree(tree):
    """Each DTensor leaf gathered whole on every rank (plain tensors
    unchanged): the one place a DTensor turns back into a local tensor."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


# --------------------------------------------------------------------------
# mesh construction
# --------------------------------------------------------------------------

def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group's
    ranks (``init_device_mesh``); the group must exist.  Every mesh of the
    port comes from here."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs a process group: run under torchrun, or "
            "call torch.distributed.init_process_group first")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))

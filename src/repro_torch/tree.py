"""Nested containers of tensors: the port's stand-in for ``jax.tree``.

A tree is a tensor, ``None`` (an empty subtree), or a list, tuple,
NamedTuple or dict of trees.  Dict entries are visited in sorted key order,
so dicts with the same keys flatten alike whatever their insertion order.
Parameters (``[{"w", "b"}, ...]``), optimizer states and ``TrainState`` are
all trees.
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> list:
    """The tensors of ``tree``, in visiting order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in leaves(sub)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        subs = [tree_map(fn, *group) for group in zip(tree, *rest)]
        return type(tree)(*subs) if _is_namedtuple(tree) else type(tree)(subs)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def rebuild(like, new_leaves) -> object:
    """A tree shaped like ``like`` holding ``new_leaves`` in visiting order."""
    it: Iterator = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(like, it: Iterator):
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree holds") from None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        subs = [_rebuild(sub, it) for sub in like]
        return type(like)(*subs) if _is_namedtuple(like) else type(like)(subs)
    raise TypeError(f"not a tree of tensors: {type(like).__name__}")


def leaves_like(like, tree) -> list:
    """The entries of ``tree`` at the tensor positions of ``like``, in
    ``leaves(like)``'s order: ``tree`` mirrors ``like``'s containers and
    holds anything at its leaves (a layout, ``None``)."""
    if like is None:
        return []
    if isinstance(like, torch.Tensor):
        return [tree]
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in leaves_like(like[k],
                                                              tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for sub, other in zip(like, tree)
                for x in leaves_like(sub, other)]
    raise TypeError(f"not a tree of tensors: {type(like).__name__}")

"""Optimizers written out (no ``torch.optim``): Adam, the paper's software
baseline, and SGD, the paper's FPGA training rule, as functional updates
on trees of tensors (counterpart of ``repro.optim.optimizers``).

    opt = adam(lr=1e-4)
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

Each update returns new tensors and mutates nothing.  The order of
operations is the JAX package's (``optimizers.py:44-66``), including the
``+ weight_decay * p`` term at its default of 0.0, so that both packages
round alike.  The SGD state is ``SgdState`` (the JAX package's
``SGDState``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.dist.sharding import replicated_like
from repro_torch.tree import leaves, rebuild, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state)


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 0-d: updates made so far
    mu: object
    nu: object


def _zero_step(params) -> torch.Tensor:
    """The int32 step counter, replicated beside DTensor params."""
    first = leaves(params)[0]
    return replicated_like(torch.zeros((), dtype=torch.int32,
                                       device=first.device), first)


def adam(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return AdamState(step=_zero_step(params),
                         mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    def update(grads, state, params):
        step = state.step + 1
        t = step.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)

        def upd(g, m, v, p):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mhat = m / c1
            vhat = v / c2
            step_ = lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)
            return p - step_, m, v

        out = [upd(g, m, v, p) for g, m, v, p in zip(
            leaves(grads), leaves(state.mu), leaves(state.nu), leaves(params))]
        return (rebuild(params, [o[0] for o in out]),
                AdamState(step=step, mu=rebuild(params, [o[1] for o in out]),
                          nu=rebuild(params, [o[2] for o in out])))

    return Optimizer(init=init, update=update)


class SgdState(NamedTuple):
    """SGD's state (the JAX package's ``SGDState``)."""
    step: torch.Tensor
    momentum: object | None


def sgd(lr: float = 1e-4, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return SgdState(step=_zero_step(params), momentum=mom)

    def update(grads, state, params):
        if momentum:
            new_mom = tree_map(lambda m, g: momentum * m + g, state.momentum,
                               grads)
            new_p = tree_map(lambda p, m: p - lr * m, params, new_mom)
            return new_p, SgdState(step=state.step + 1, momentum=new_mom)
        new_p = tree_map(lambda p, g: p - lr * g, params, grads)
        return new_p, SgdState(step=state.step + 1, momentum=None)

    return Optimizer(init=init, update=update)


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    gnorm = global_norm(grads)
    # a true division by a device tensor, never a multiply by a reciprocal
    scale = torch.clamp(torch.full_like(gnorm, max_norm)
                        / torch.clamp_min(gnorm, 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm

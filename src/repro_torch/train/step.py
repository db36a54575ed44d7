"""The training step of the MRF nets and the LMs (counterpart of
``repro.train.step``).

Composes: loss forward -> gradients by autograd -> optional sequential
microbatch accumulation -> optional clipping by global norm -> Adam/SGD
update.  Every step factory returns ``(state, batch) -> (state, metrics)``
over a :class:`TrainState`, whose ``aux`` carries backend state (the QAT
activation observers) through checkpoints with everything else.

The backend plugs in at one of two levels:

* ``aux_loss=True``: ``loss_fn(params, aux, batch) -> (loss, new_aux)``.
* ``fused_step``: a whole-step override ``(params, opt_state, aux, batch)
  -> (new_params, new_opt_state, new_aux, metrics)`` for updates computed
  in a kernel (``kernels/fused_train``).  The factory **refuses**
  ``microbatches > 1`` and ``grad_compress`` for it: there is no gradient
  tree to accumulate or compress.

``grad_compress`` runs the int8 error-feedback compression
(``optim.grad_compression``) on the clipped gradients, its residual
carried in ``TrainState.ef_residual``.  Steps run eagerly, so
``make_chunked_step`` is a Python loop of ``n`` steps with the metrics
stacked.  A batch is a dict of tensors with a leading batch axis (the MRF
nets' features and targets; an LM's tokens, labels and prefix
embeddings); ``microbatches=M`` cuts every entry into M equal slices along
it, in order, as the reference's ``resh`` does.

Params may be DTensors (``launch/train.py --mesh``): each gradient is then
redistributed onto its parameter's placements as autograd hands it back
(``dist.sharding.placed_like``) — the data-parallel all-reduce, or
reduce-scatter onto an ``fsdp`` shard, made explicit — so the clipping,
the compression (on the reduced gradient, as in the reference), the
update, the optimizer state and ``ef_residual`` keep the params' layout.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.dist.sharding import placed_like, replicated_like
from repro_torch.optim.grad_compression import error_feedback_compress
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          global_norm)
from repro_torch.tree import leaves, rebuild, tree_map


class TrainState(NamedTuple):
    step: torch.Tensor       # int32 0-d
    params: Any
    opt_state: Any
    ef_residual: Any | None  # int8-compression error feedback
    aux: Any | None = None   # backend state (QAT observers); checkpointed


def init_train_state(params, opt: Optimizer, *, grad_compress: bool = False,
                     aux=None) -> TrainState:
    first = leaves(params)[0]
    return TrainState(step=replicated_like(
                          torch.zeros((), dtype=torch.int32,
                                      device=first.device), first),
                      params=params, opt_state=opt.init(params),
                      ef_residual=tree_map(torch.zeros_like, params)
                      if grad_compress else None, aux=aux)


def make_train_step(loss_fn, opt: Optimizer, *, microbatches: int = 1,
                    max_grad_norm: float | None = 1.0,
                    grad_compress: bool = False, aux_loss: bool = False,
                    fused_step=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    With ``microbatches=M`` each batch leaf is cut into M equal slices along
    its first axis and the gradients are accumulated in order, then
    averaged.  ``max_grad_norm=None`` disables clipping (the norm is still
    reported).  ``fused_step`` replaces the whole gradient + update pipeline
    (``loss_fn`` may be None then).
    """
    if fused_step is not None:
        if microbatches != 1:
            raise ValueError(
                f"fused_step computes grads+update in-kernel: there is no "
                f"grad tree to accumulate, so microbatches={microbatches} "
                f"cannot be honored (use a stepwise backend)")
        if grad_compress:
            raise ValueError(
                "fused_step computes grads+update in-kernel: there is no "
                "grad tree to compress, so grad_compress cannot be honored "
                "(use a stepwise backend)")

        def fused_train_step(state: TrainState, batch):
            new_params, new_opt, new_aux, metrics = fused_step(
                state.params, state.opt_state, state.aux, batch)
            return TrainState(step=state.step + 1, params=new_params,
                              opt_state=new_opt,
                              ef_residual=state.ef_residual,
                              aux=new_aux), metrics
        return fused_train_step

    def grads_of(params, aux, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        if aux_loss:
            loss, new_aux = loss_fn(live, aux, batch)
            new_aux = tree_map(torch.Tensor.detach, new_aux)
        else:
            loss, new_aux = loss_fn(live, batch), aux
        # a param the loss does not reach (``ln2`` under parallel_block)
        # gets a zero gradient, as ``jax.grad`` gives it
        grads = [placed_like(g, p) for g, p in
                 zip(torch.autograd.grad(loss, leaves(live),
                                         materialize_grads=True),
                     leaves(live))]
        return loss.detach(), rebuild(params, grads), new_aux

    def train_step(state: TrainState, batch):
        params = state.params
        if microbatches == 1:
            loss, grads, aux = grads_of(params, state.aux, batch)
        else:
            def piece(i):
                def cut(x):
                    b = x.shape[0]
                    if b % microbatches:
                        raise ValueError(f"batch {b} is not divisible into "
                                         f"{microbatches} microbatches")
                    m = b // microbatches
                    return x[i * m:(i + 1) * m]
                return {k: cut(v) for k, v in batch.items()}

            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            grads, aux = tree_map(torch.zeros_like, params), state.aux
            for i in range(microbatches):
                loss_i, g_i, aux = grads_of(params, aux, piece(i))
                loss = loss + loss_i
                grads = tree_map(torch.add, grads, g_i)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)

        with torch.no_grad():
            if max_grad_norm is None:
                gnorm = global_norm(grads)
            else:
                grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            residual = state.ef_residual
            if grad_compress:
                grads, residual = error_feedback_compress(grads, residual)
            new_params, new_opt = opt.update(grads, state.opt_state, params)
        return TrainState(step=state.step + 1, params=new_params,
                          opt_state=new_opt, ef_residual=residual,
                          aux=aux), {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_chunked_step(train_step, batch_at):
    """``chunk_step(state, start, n) -> (state, metrics)``: ``n`` steps of
    ``train_step`` on ``batch_at(start + k)``, ``k = 0..n-1``, with each
    metric stacked to ``(n,)``.  The same steps on the same batches as the
    stepwise loop, so the result is the same bits."""
    def chunk_step(state: TrainState, start: int, n: int):
        per_step = []
        for k in range(n):
            state, metrics = train_step(state, batch_at(start + k))
            per_step.append(metrics)
        return state, {key: torch.stack([m[key] for m in per_step])
                       for key in per_step[0]}
    return chunk_step

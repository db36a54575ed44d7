"""Public functions around the fused training kernel (counterpart of
``repro.kernels.fused_train.ops``): pack the MRF net's layer list into the
kernel's buffer, run the kernel, unpack back to ``[{"w", "b"}]``.

The kernel keeps the layers at their true widths, so packing is a
concatenation, not the JAX package's zero padding to ``(L, 128, 128)``:
``pack_params`` / ``unpack_params`` stand for its ``pad_params`` /
``unpad_params``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_train.kernel import fused_train_call
from repro_torch.kernels.fused_train.multistep import (
    fused_train_adam_call, fused_train_multistep_call)
from repro_torch.kernels.fused_train.ref import layer_views
from repro_torch.optim.optimizers import AdamState

# Optimizer rules the fused kernel implements.  Anything else must use a
# stepwise backend (the kernel would silently train with the wrong rule).
FUSED_OPTIMIZERS = ("sgd", "adam")


def pack_params(params) -> tuple:
    """``[{"w": (K, N), "b": (N,)}]`` -> ``(flat fp32 buffer, widths)``:
    per layer W row-major, then b (``ref.layer_views`` reads it back)."""
    widths = (int(params[0]["w"].shape[0]),)
    for l, layer in enumerate(params):
        k, n = layer["w"].shape
        if k != widths[-1] or tuple(layer["b"].shape) != (n,):
            raise ValueError(f"layer {l}: w {tuple(layer['w'].shape)}, b "
                             f"{tuple(layer['b'].shape)} after width "
                             f"{widths[-1]}")
        widths += (int(n),)
    flat = torch.cat([t.reshape(-1).to(torch.float32)
                      for layer in params for t in (layer["w"], layer["b"])])
    return flat, widths


def unpack_params(flat, widths) -> list:
    """Inverse of :func:`pack_params` (views into ``flat``)."""
    return [{"w": w, "b": b} for w, b in layer_views(flat, widths)]


def _rows(t):
    return t.to(torch.float32).contiguous()


def fused_train_step(params, x, y, *, lr: float, tile_batch: int = 128,
                     qat: bool = False, cluster: int | None = None):
    """One fused pass over the batch x (B, D_in) / y (B, out): the tiles
    stream through the resident net.  ``cluster``: the kernel's cluster
    size (default ``kernel.cluster_size``).  Returns (new_params, per-tile
    losses)."""
    if x.shape[0] % tile_batch:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                         f"tile_batch {tile_batch}")
    flat, widths = pack_params(params)
    new, losses = fused_train_call(_rows(x), _rows(y), flat, widths=widths,
                                   lr=lr, tile_batch=tile_batch, qat=qat,
                                   cluster=cluster)
    return unpack_params(new, widths), losses


def effective_tile(batch: int, tile_batch: int) -> int:
    """Largest tile <= tile_batch that divides ``batch``; degrades toward
    per-sample streaming rather than failing on awkward batch sizes."""
    t = min(tile_batch, batch)
    while batch % t:
        t -= 1
    return t


def step_losses(losses):
    """Each step's loss from the ``(K, n_tiles)`` tile losses: the row
    mean, summed left to right, so a row gives the same bits whatever the
    number of rows (chunked and stepwise runs report alike)."""
    return losses.cumsum(dim=1)[:, -1] / losses.shape[1]


def fused_train_multistep(params, opt_state, x, y, *, n_steps: int,
                          lr: float, optimizer: str = "sgd",
                          tile_batch: int = 128, qat: bool = False,
                          cluster: int | None = None):
    """K training steps in **one** kernel launch, the net (and Adam's
    moments) resident across all of them.

    ``x``/``y``: ``(K*B, d_in)`` / ``(K*B, out_dim)``, K steps' batches
    back to back.  The tile is the largest divisor of the per-step batch B
    not above ``tile_batch``; ``cluster`` as in :func:`fused_train_step`.
    ``opt_state``: for ``"adam"`` an
    ``AdamState``, whose ``step`` advances by ``n_steps * n_tiles`` (one
    Adam update per tile); for ``"sgd"`` any state with a ``step`` field
    (advanced by ``n_steps``) or None.

    Returns ``(new_params, new_opt_state, losses (K, n_tiles))``.
    """
    total = x.shape[0]
    if n_steps < 1 or total % n_steps:
        raise ValueError(f"staged stream of {total} rows is not divisible "
                         f"into n_steps={n_steps} equal batches")
    per_step = total // n_steps
    tile = effective_tile(per_step, tile_batch)
    n_tiles = per_step // tile
    flat, widths = pack_params(params)
    x, y = _rows(x), _rows(y)
    if optimizer == "sgd":
        new, tile_losses = fused_train_multistep_call(
            x, y, flat, widths=widths, lr=lr, tile_batch=tile, qat=qat,
            cluster=cluster)
        new_opt = opt_state
        if opt_state is not None and hasattr(opt_state, "step"):
            new_opt = opt_state._replace(step=opt_state.step + n_steps)
    elif optimizer == "adam":
        if not isinstance(opt_state, AdamState):
            raise ValueError(
                f"optimizer='adam' needs an AdamState, got {type(opt_state)!r}"
                " — build it with optim.optimizers.adam(lr).init(params)")
        mu, _ = pack_params(opt_state.mu)
        nu, _ = pack_params(opt_state.nu)
        step0 = opt_state.step.to(torch.int32).reshape(1)
        new, mu_new, nu_new, tile_losses = fused_train_adam_call(
            step0, x, y, flat, mu, nu, widths=widths, lr=lr, tile_batch=tile,
            qat=qat, cluster=cluster)
        new_opt = AdamState(step=opt_state.step + n_steps * n_tiles,
                            mu=unpack_params(mu_new, widths),
                            nu=unpack_params(nu_new, widths))
    else:
        raise ValueError(
            f"fused backend implements optimizers {FUSED_OPTIMIZERS}, got "
            f"{optimizer!r}; use a stepwise backend for anything else")
    return (unpack_params(new, widths), new_opt,
            tile_losses.reshape(n_steps, n_tiles))


def make_engine_step(*, lr: float, optimizer: str = "sgd",
                     tile_batch: int = 128, qat: bool = False):
    """The ``fused_step`` of ``train.step.make_train_step``: ``(params,
    opt_state, aux, batch) -> (new_params, new_opt_state, aux, metrics)``
    with the gradients and the update inside the kernel; ``metrics["loss"]``
    is the mean of the step's per-tile losses.  Raises ``ValueError`` for an
    optimizer the kernel does not implement."""
    if optimizer not in FUSED_OPTIMIZERS:
        raise ValueError(
            f"the fused backend trains in the kernel and implements only "
            f"{FUSED_OPTIMIZERS}; got optimizer={optimizer!r}. Use "
            f"backend='float' (or another stepwise backend) for it.")

    def fused(params, opt_state, aux, batch):
        new_params, new_opt, losses = fused_train_multistep(
            params, opt_state, batch["x"], batch["y"], n_steps=1, lr=lr,
            optimizer=optimizer, tile_batch=tile_batch, qat=qat)
        return new_params, new_opt, aux, {"loss": step_losses(losses)[0]}
    return fused

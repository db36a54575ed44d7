"""Wrapper of the fused training CUDA kernel (``csrc/fused_train.cu``) for
one training step: ``fused_train_call``, the port of
``repro.kernels.fused_train.kernel.fused_train_call`` (B1).

The kernel trains the whole net over sequential batch tiles in one launch —
forward, masked MSE, hand-derived backward, in-place update — on one
thread-block cluster: each block holds a replica of the net and takes a
share of each tile's rows, and dW/db are reduced across the cluster
(``csrc/fused_train.cu`` says how).  The net is packed in one fp32 buffer
in the JAX ``(in, out)`` layout at its true widths (``ref.layer_views``; no
128-lane padding).  :func:`train_plan` lays out each block's shared memory
and :func:`cluster_size` picks the cluster from the tile and the widths.
B1 is the K = 1 case of the same kernel as ``multistep.py``'s B2 and B3:
:func:`run_fused_train` launches it for all three, and each wrapper counts
its own launches in ``.launches``.

A CPU tensor runs the plain version (``ref.fused_train_plain``); a CUDA
tensor launches the kernel or raises.  Outputs are new tensors; inputs are
not mutated.  The launch goes on the current stream and does not
synchronise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import refuse_dtensor, refuse_grad
from repro_torch.kernels.fused_train.ref import (AdamRule, fused_train_plain,
                                                 packed_size)

SMEM_MAX = 232_448  # bytes of shared memory a block may use on sm_90
MAX_LAYERS = 16     # kMaxLayers in the .cu
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 8 is the portable cluster size, 16 not
ROWS_PER_BLOCK = 16  # the default cluster gives a block at most this many rows
PLAN_FLOATS = 288   # kPlanFloats: the plan and two mbarriers, at the start
_FLOATS = SMEM_MAX // 4


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


class TrainPlan(NamedTuple):
    """Where the cluster kernel keeps what: one launch's layout.

    ``ints`` is what the kernel reads (``struct Plan`` in the .cu, in its
    field order); the rest describes it.  Shared-memory sizes are per block.
    """
    cluster: int
    rows: int            # the most rows of a tile one block takes
    rpad: int            # rows of its buffers (rows to the register tile)
    smem_bytes: int      # shared memory of a block
    required_bytes: int  # of which the replica, the rows and the deltas
    wq_in_smem: bool     # QAT's fake-quantized weights in shared memory
    part_in_smem: tuple  # per layer: its partial dW/db in shared memory
    bulk: bool           # dW/db and the new weights move by bulk copies
    gws_stride: int      # floats of global workspace a block
    ints: tuple


def train_plan(widths, tile: int, cluster: int, qat: bool = False
               ) -> TrainPlan:
    """The layout of one launch: each block's shared memory (in order: the
    plan itself, every layer's W and b, QAT's column scales, two x and two y
    row buffers, each hidden layer's activations, two delta buffers, the
    loss terms; then every layer's partial dW/db and the owners' receive
    buffers if they all fit (the bulk exchange), else the partials that fit,
    the smaller layers first; then the fake-quantized weights if they fit)
    and its region of the global workspace (what did not fit).  Widths are
    padded to 4 floats (16-byte loads), activation and delta rows by 4 more
    (rows 4 banks apart).  Raises ``ValueError`` for a cluster other than
    1, 2, 4, 8 or 16, and when the replica, the rows and the deltas do not
    fit one block."""
    widths = _check_widths(widths)
    if cluster not in CLUSTER_SIZES or tile < 1:
        raise ValueError(f"cluster {cluster} (one of {CLUSTER_SIZES}), tile "
                         f"{tile}")
    n_layers = len(widths) - 1
    rows = -(-tile // cluster)
    mt = 1 if rows == 1 else 2
    rpad = -(-rows // mt) * mt
    pw = [_pad4(w) for w in widths]
    at = PLAN_FLOATS

    def take(n):
        nonlocal at
        off, at = at, at + _pad4(n)
        return off

    w_off = []
    for pk, pn in zip(pw[:-1], pw[1:]):
        w_off.append(take(pk * pn))
        take(pn)
    qs = [take(pn) for pn in pw[1:]]
    sx, sy, sd = pw[0] + 4, pw[-1], max(pw[1:]) + 4
    xb = [take(rpad * sx) for _ in range(2)]
    yb = [take(rpad * sy) for _ in range(2)]
    act = [take(rpad * (pn + 4)) for pn in pw[1:-1]] + [-1]
    dz = [take(rpad * sd) for _ in range(2)]
    sq = take(rpad * sy)
    misc = take(4)
    required = at
    if required > _FLOATS:
        raise ValueError(
            f"net {widths} at tile {tile}, cluster {cluster}: a block needs "
            f"{4 * required} B of shared memory for the weights, its "
            f"{rows} rows and their deltas; it has {SMEM_MAX}")
    sizes = [pk * pn + pn for pk, pn in zip(pw[:-1], pw[1:])]
    slots = [-(-size // 4 // cluster) * 4 for size in sizes]
    recv_size = (sum(cluster * slot for slot in slots) + 4 * cluster
                 if cluster > 1 else 0)
    # the bulk exchange: every partial and the owners' receive buffers in
    # shared memory; else partials where they fit, read in place
    bulk = at + sum(sizes) + recv_size <= _FLOATS
    part, part_in_smem = [0] * n_layers, [False] * n_layers
    if bulk:
        for l in range(n_layers):
            part[l], part_in_smem[l] = take(sizes[l]), True
        recv = [take(cluster * slot) if cluster > 1 else 0 for slot in slots]
        recv_loss = take(4 * cluster) if cluster > 1 else 0
    else:
        for l in sorted(range(n_layers), key=lambda l: (sizes[l], l)):
            if at + sizes[l] <= _FLOATS:
                part[l], part_in_smem[l] = take(sizes[l]), True
        recv, recv_loss = [0] * n_layers, 0
    wq_size = sum(pk * pn for pk, pn in zip(pw[:-1], pw[1:]))
    wq_in_smem = qat and at + wq_size <= _FLOATS
    g = 0  # floats of the block's global region
    if wq_in_smem:
        wq = [take(pk * pn) for pk, pn in zip(pw[:-1], pw[1:])]
    elif qat:
        wq = []
        for pk, pn in zip(pw[:-1], pw[1:]):
            wq.append(g)
            g += pk * pn
    else:
        wq = list(w_off)
    for l in range(n_layers):
        if not part_in_smem[l]:
            part[l] = g
            g += sizes[l]
    ints = [n_layers, cluster, tile, rpad, mt, at, g,
            int(qat and not wq_in_smem), int(bulk), recv_loss, *xb, sx, *yb,
            sy, *dz, sd, sq, misc]
    packed = 0
    for l, (k, n) in enumerate(zip(widths[:-1], widths[1:])):
        pk, pn = pw[l], pw[l + 1]
        ints += [k, n, pk, pn, w_off[l], w_off[l] + pk * pn, wq[l], qs[l],
                 act[l], pn + 4, part[l], int(not part_in_smem[l]),
                 recv[l], slots[l], packed, packed + k * n]
        packed += k * n + n
    return TrainPlan(cluster, rows, rpad, 4 * at, 4 * required, wq_in_smem,
                     tuple(part_in_smem), bulk, g, tuple(ints))


def cluster_size(tile: int, widths) -> int:
    """The cluster the wrappers launch for this tile and net, a function of
    nothing else (so a K-step launch and K single-step launches sum alike):
    the fewest blocks, up to the portable 8, that leave each at most
    ``ROWS_PER_BLOCK`` rows, then more until the rows fit a block."""
    c = 1
    while c < 8 and -(-tile // c) > ROWS_PER_BLOCK:
        c *= 2
    while True:
        try:
            train_plan(widths, tile, c)
            return c
        except ValueError:
            if c >= CLUSTER_SIZES[-1]:
                raise
            c *= 2


def cluster_sizes(tile: int, widths) -> tuple:
    """Every power-of-two cluster whose plan fits a block at this tile."""
    out = []
    for c in CLUSTER_SIZES:
        try:
            train_plan(widths, tile, c)
            out.append(c)
        except ValueError:
            pass
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("fused_train").fused_train_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_widths(widths) -> tuple:
    widths = tuple(int(w) for w in widths)
    if not 2 <= len(widths) <= MAX_LAYERS + 1 or min(widths) < 1:
        raise ValueError(f"widths {widths}: want 1..{MAX_LAYERS} layers of "
                         f"positive width")
    return widths


def _check_tensor(name, t, dev, shape, dtype=torch.float32):
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, x on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype}{tuple(shape)}, got "
                         f"{t.dtype}{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def run_fused_train(x, y, params, widths, *, lr: float, tile_batch: int,
                    qat: bool = False, moments=None, step0=None,
                    rule: AdamRule = AdamRule(), cluster: int | None = None):
    """Every ``tile_batch`` rows of x (rows, widths[0]) / y (rows,
    widths[-1]) one update of the packed net ``params``, in order; Adam with
    ``moments=(mu, nu)`` and the int32 ``step0``, else SGD.  On the card one
    cluster of ``cluster`` blocks (default :func:`cluster_size`) trains; the
    size launched is kept in ``run_fused_train.last_cluster``.

    Returns ``(params, mu, nu, losses (n_tiles,), launched)``;
    ``launched`` is False on the CPU and when there are no rows.  The
    update is computed in the kernel, not by autograd: raises under grad
    for an input that requires one, on either device.
    """
    refuse_dtensor("fused_train", x, y, params, step0,
                   *(moments if moments is not None else ()))
    refuse_grad("fused_train", x, y, params, step0,
                *(moments if moments is not None else ()))
    widths = _check_widths(widths)
    rows = x.shape[0]
    if tile_batch < 1 or rows % tile_batch:
        raise ValueError(f"{rows} rows are not a whole number of tiles of "
                         f"{tile_batch}")
    if (moments is None) != (step0 is None):
        raise ValueError("Adam needs both moments and step0; SGD neither")
    kw = dict(lr=lr, tile_batch=tile_batch, qat=qat, moments=moments,
              step0=step0, rule=rule)
    if x.device.type == "cpu":
        return (*fused_train_plain(x, y, params, widths, **kw), False)
    if x.device.type != "cuda":
        raise ValueError(f"fused_train: unsupported device {x.device}")
    dev = x.device
    n = packed_size(widths)
    _check_tensor("x", x, dev, (rows, widths[0]))
    _check_tensor("y", y, dev, (rows, widths[-1]))
    _check_tensor("params", params, dev, (n,))
    if moments is not None:
        _check_tensor("mu", moments[0], dev, (n,))
        _check_tensor("nu", moments[1], dev, (n,))
        _check_tensor("step0", step0, dev, (1,), torch.int32)
    plan = train_plan(widths, tile_batch, cluster_size(tile_batch, widths)
                      if cluster is None else cluster, qat)
    build.check_device(dev)
    p_out = torch.empty_like(params)
    mu_out = nu_out = None
    if moments is not None:
        mu_out, nu_out = torch.empty_like(moments[0]), torch.empty_like(
            moments[1])
    n_tiles = rows // tile_batch
    losses = torch.empty((n_tiles,), dtype=torch.float32, device=dev)
    if rows == 0:  # nothing to launch, nothing to count
        p_out.copy_(params)
        if moments is not None:
            mu_out.copy_(moments[0])
            nu_out.copy_(moments[1])
        return p_out, mu_out, nu_out, losses, False
    gws = (torch.empty((plan.cluster * plan.gws_stride,), device=dev)
           if plan.gws_stride else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _entry()(
        x.data_ptr(), y.data_ptr(), rows,
        (ctypes.c_int * len(plan.ints))(*plan.ints), len(plan.ints),
        params.data_ptr(), p_out.data_ptr(),
        ptr(moments[0] if moments else None),
        ptr(moments[1] if moments else None), ptr(mu_out), ptr(nu_out),
        ptr(step0), losses.data_ptr(), ptr(gws),
        lr, rule.b1, rule.b2, 1 - rule.b1, 1 - rule.b2, rule.eps,
        rule.weight_decay, int(qat), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_train kernel launch failed (cluster "
                           f"{plan.cluster}): CUDA error {err}")
    run_fused_train.last_cluster = plan.cluster
    return p_out, mu_out, nu_out, losses, True


run_fused_train.last_cluster = None


def fused_train_call(x, y, params, *, widths, lr: float, tile_batch: int,
                     qat: bool = False, cluster: int | None = None):
    """One fused SGD pass over the batch (B1): ``(params, losses)``.

    x (B, widths[0]), y (B, widths[-1]) fp32; ``params`` the packed net
    (``ops.pack_params``); B a multiple of ``tile_batch``.
    """
    p, _, _, losses, launched = run_fused_train(
        x, y, params, widths, lr=lr, tile_batch=tile_batch, qat=qat,
        cluster=cluster)
    if launched:
        fused_train_call.launches += 1
    return p, losses


fused_train_call.launches = 0

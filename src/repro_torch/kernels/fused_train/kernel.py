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

The per-sample stream (tile 1, SGD, no QAT) has a kernel of its own in the
same source, ``fused_train_kernel_per_sample``: one block, each thread's
4 x 4 tiles of the weights in registers for the whole launch, the update
fused into the backward pass.  :func:`per_sample_schedule` builds its
schedule; :func:`run_fused_train` takes it where the schedule fits
(``fits``) and the caller names no cluster, and counts those launches in
``run_fused_train.per_sample_launches``.

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


# The per-sample kernel (``fused_train_kernel_per_sample``): constants of
# the .cu, and the layout of its table (struct PsTable).
PS_THREADS = 256    # kPsThreads
_PS_WARPS = PS_THREADS // 32
PS_MAX_LAYERS = 7   # kPsMaxLayers: a thread keeps a 4 x 4 tile of each
_PS_MAX_ROWS = 4    # kPsMaxRows: partial rows a sum reads
_PS_MAX_GROUP = 8   # kPsMaxGroup: lanes a join spans, each way
_PS_MAX_CHUNKS = 64  # 4-wide chunks a width: a descriptor's 6 bits each
PS_HEADER_INTS, PS_LAYER_INTS, PS_PHASE_INTS = 16, 8, 16
PS_TABLE_INTS = (PS_HEADER_INTS + PS_LAYER_INTS * PS_MAX_LAYERS
                 + PS_PHASE_INTS * 2 * PS_MAX_LAYERS)
# a slot's flags (kPsValid ... kPsLossOwner)
PS_VALID, PS_FWD_WRITER, PS_BWD_WRITER = 1, 2, 4
PS_BIAS_OWNER, PS_ACT_WRITER, PS_LOSS_OWNER = 8, 16, 32


class Tile(NamedTuple):
    """One 4 x 4 tile of a layer's padded W held by one lane: rows 4 kq..,
    columns 4 nq..; the partial rows its lane group writes; ``flags`` as
    the .cu's kPs* bits."""
    layer: int
    kq: int
    nq: int
    frow: int   # forward: its group's partial row of z
    brow: int   # backward: its group's partial row of dh
    flags: int


class SampleSchedule(NamedTuple):
    """The per-sample kernel's schedule for one net: which warps and lanes
    hold which tiles, and every phase's buffers and barrier.

    ``fits`` is False (``why`` says what does not) when the net exceeds
    the kernel's register budget: ``PS_MAX_LAYERS`` layers (one register
    tile each a thread), 8 warps a layer, ``_PS_MAX_ROWS`` partial rows a
    sum.  ``slots[tid][l]`` is the :class:`Tile` of layer ``l``
    that thread ``tid`` holds (None: none); ``table`` and ``descriptors``
    are what the kernel reads (struct PsTable, and ``PS_MAX_LAYERS`` ints a
    thread), only where the net fits.
    """
    fits: bool
    why: str
    lanes: tuple      # per layer (gk, gn): a warp's block, the join groups
    warps: tuple      # per layer: its warps
    slots: tuple
    smem_bytes: int
    table: tuple
    descriptors: tuple


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _lane_groups(kq: int, nq: int) -> tuple:
    """(gk, gn) for a layer of kq x nq tiles, each at most
    ``_PS_MAX_GROUP``: a warp holds gk x gn tiles; the forward joins gk
    lanes, the backward gn.  The fewest warps, then the fewest partial rows
    (forward plus backward), then the fewest lanes a warp, then the smaller
    forward group."""
    best = None
    sizes = [g for g in (1, 2, 4, 8, 16, 32) if g <= _PS_MAX_GROUP]
    for gk in sizes:
        for gn in sizes:
            if gk * gn > 32 or gk > _pow2_at_least(kq) or \
                    gn > _pow2_at_least(nq):
                continue
            wk, wn = -(-kq // gk), -(-nq // gn)
            key = (wk * wn, wk + wn, gk * gn, gk)
            if best is None or key < best[0]:
                best = (key, (gk, gn))
    return best[1]


@functools.lru_cache(maxsize=None)
def per_sample_schedule(widths) -> SampleSchedule:
    """The per-sample kernel's schedule for a net (a function of the widths
    alone, built once): each layer's padded W in 4 x 4 tiles, one a lane,
    in blocks of :func:`_lane_groups` over its warps (``csrc/fused_train.cu``
    says how); the layers of one warp in the last warp, every other layer
    from warp 0; layer l's tile in register slot l."""
    widths = _check_widths(widths)
    n_layers = len(widths) - 1
    pw = [_pad4(w) for w in widths]
    lanes, warps, why = [], [], []
    for l in range(n_layers):
        kq, nq = pw[l] // 4, pw[l + 1] // 4
        gk, gn = _lane_groups(kq, nq)
        wk, wn = -(-kq // gk), -(-nq // gn)
        lanes.append((gk, gn))
        nw = wk * wn
        warps.append(tuple(range(nw)) if nw > 1 else (_PS_WARPS - 1,))
        if max(kq, nq) > _PS_MAX_CHUNKS:
            why.append(f"layer {l}: {4 * max(kq, nq)} wide > "
                       f"{4 * _PS_MAX_CHUNKS}")
        if nw > _PS_WARPS:
            why.append(f"layer {l}: {nw} warps > {_PS_WARPS}")
        if max(wk, wn) > _PS_MAX_ROWS:
            why.append(f"layer {l}: {max(wk, wn)} partial rows > "
                       f"{_PS_MAX_ROWS}")
    if n_layers > PS_MAX_LAYERS:
        why.append(f"{n_layers} layers > {PS_MAX_LAYERS}")
    slots = [[None] * max(n_layers, PS_MAX_LAYERS) for _ in range(32 * max(
        _PS_WARPS, max(max(w) for w in warps) + 1))]
    for l in range(n_layers):
        kq_n, nq_n = pw[l] // 4, pw[l + 1] // 4
        gk, gn = lanes[l]
        wk_n = -(-kq_n // gk)
        for wi, w in enumerate(warps[l]):
            wk, wn = wi % wk_n, wi // wk_n
            for lane in range(32):
                kl, nl = lane % gk, lane // gk
                kq, nq = wk * gk + kl, wn * gn + nl
                flags = 0
                if nl < gn and kq < kq_n and nq < nq_n:
                    flags |= PS_VALID
                    flags |= PS_FWD_WRITER if kl == 0 else 0
                    flags |= PS_BWD_WRITER if nl == 0 and l > 0 else 0
                    flags |= PS_BIAS_OWNER if kq == 0 else 0
                    flags |= PS_ACT_WRITER if nq == 0 and l > 0 else 0
                    flags |= PS_LOSS_OWNER if (
                        l == n_layers - 1 and kq == 0 and nq == 0) else 0
                else:  # a lane past the layer's tiles reads tile (0, 0)
                    kq = nq = 0
                slots[32 * w + lane][l] = Tile(l, kq, nq, wk, wn, flags)
    fits = not why
    table, descriptors, smem_bytes = (), (), 0
    if fits:
        table, smem_bytes = _per_sample_table(widths, lanes, warps)
        descriptors = tuple(
            _descriptor(t) for row in slots for t in row)
    return SampleSchedule(fits, "; ".join(why), tuple(lanes), tuple(warps),
                          tuple(tuple(r) for r in slots), smem_bytes, table,
                          descriptors)


def _descriptor(t) -> int:
    if t is None:
        return 0
    return t.kq | t.nq << 6 | t.frow << 12 | t.brow << 15 | t.flags << 18


def _per_sample_table(widths, lanes, warps) -> tuple:
    """(struct PsTable as ints, shared-memory bytes): the header, each
    layer's widths and packed offsets, and each phase's row.  Layer l's
    forward leaves one partial row of z a row of warps (its lane groups
    joined), its backward one partial row of dh a column of warps."""
    n_layers = len(widths) - 1
    pw = [_pad4(w) for w in widths]
    at = PS_TABLE_INTS

    def take(n):
        nonlocal at
        off, at = at, at + _pad4(n)
        return off

    xb = [take(pw[0]) for _ in range(2)]
    yb = [take(pw[-1]) for _ in range(2)]
    frows = [-(-pw[l] // 4 // gk) for l, (gk, _) in enumerate(lanes)]
    brows = [-(-pw[l + 1] // 4 // gn) for l, (_, gn) in enumerate(lanes)]
    fpart = [take(frows[l] * pw[l + 1]) for l in range(n_layers)]
    bpart = [take(brows[l] * pw[l]) if l > 0 else -1
             for l in range(n_layers)]
    act = [take(pw[l + 1]) for l in range(n_layers - 1)]
    header = [n_layers, 2 * n_layers, at, *xb, *yb, widths[0], widths[-1],
              pw[-1] // 4]
    table = header + [0] * (PS_HEADER_INTS - len(header))
    packed = 0
    for l in range(PS_MAX_LAYERS):
        if l < n_layers:
            k, n = widths[l], widths[l + 1]
            table += [k, n, packed, packed + k * n]
            packed += k * n + n
        else:
            table += [0] * 4
        table += [0] * (PS_LAYER_INTS - 4)
    masks = [sum(1 << w for w in ws) for ws in warps]
    # phases: the forward of layers 0..L-1, then their backward, L-1..0
    order = [(l, True) for l in range(n_layers)] + [
        (l, False) for l in range(n_layers - 1, -1, -1)]
    rows = []
    for l, fwd in order:
        if fwd:
            src = (-1, 1, 0) if l == 0 else (fpart[l - 1], frows[l - 1],
                                             pw[l])
            keep = act[l - 1] if l > 0 else -1
            row = [masks[l], *src, keep, -1, fpart[l], pw[l + 1]]
        elif l == n_layers - 1:
            row = [masks[l], fpart[l], frows[l], pw[l + 1], -1,
                   act[l - 1] if l > 0 else -1, bpart[l], pw[l]]
        else:
            row = [masks[l], bpart[l + 1], brows[l + 1], pw[l + 1], act[l],
                   act[l - 1] if l > 0 else -1, bpart[l], pw[l]]
        rows.append(row + list(lanes[l]))
    for p, row in enumerate(rows):
        # the barrier: the warps of this phase and the next; after the last
        # phase the sample's closing __syncthreads
        bar_warps = row[0] | rows[p + 1][0] if p + 1 < len(rows) else 0
        n_bar = 32 * bin(bar_warps).count("1")
        bar_id = 0 if n_bar in (0, 32, PS_THREADS) else p + 1
        table += row + [bar_warps, bar_id, n_bar] + [0] * (
            PS_PHASE_INTS - len(row) - 3)
    table += [0] * (PS_TABLE_INTS - len(table))
    return tuple(table), 4 * at


def takes_per_sample_path(widths, tile_batch: int, *, qat: bool,
                          adam: bool, cluster: int | None) -> bool:
    """Whether a launch goes to the per-sample kernel: tile 1, SGD, no QAT,
    a net within its budget, and no cluster named by the caller (an
    explicit cluster launches the cluster kernel at that size)."""
    return (tile_batch == 1 and not qat and not adam and cluster is None
            and per_sample_schedule(tuple(widths)).fits)


@functools.lru_cache(maxsize=None)
def _descriptors_on(widths, device) -> torch.Tensor:
    """The schedule's per-thread descriptors on ``device``, copied once."""
    return torch.tensor(per_sample_schedule(widths).descriptors,
                        dtype=torch.int32).to(device)


@functools.lru_cache(maxsize=None)
def _ps_entry():
    fn = build.load("fused_train").fused_train_per_sample_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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

    Tile 1 with SGD and no QAT, for a net within its budget and with no
    ``cluster`` given, launches the per-sample kernel instead
    (:func:`takes_per_sample_path`); ``last_cluster`` is then 1 and
    ``run_fused_train.per_sample_launches`` counts the launch.
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
    per_sample = takes_per_sample_path(widths, tile_batch, qat=qat,
                                       adam=moments is not None,
                                       cluster=cluster)
    plan = None if per_sample else train_plan(
        widths, tile_batch, cluster_size(tile_batch, widths)
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
    if per_sample:
        sched = per_sample_schedule(widths)
        err = _ps_entry()(
            x.data_ptr(), y.data_ptr(), rows,
            (ctypes.c_int * len(sched.table))(*sched.table), len(sched.table),
            _descriptors_on(widths, dev).data_ptr(), params.data_ptr(),
            p_out.data_ptr(), losses.data_ptr(), lr,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"fused_train per-sample kernel launch failed:"
                               f" CUDA error {err}")
        run_fused_train.last_cluster = 1
        run_fused_train.per_sample_launches += 1
        return p_out, None, None, losses, True
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
run_fused_train.per_sample_launches = 0


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

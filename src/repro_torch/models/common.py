"""Shared LM components (counterpart of ``repro.models.common``): RMSNorm,
the dense projection with the paper's int8 QAT (``quant="qat-int8"``:
:func:`fake_quantize_int8` on both operands) and its deployment form
(``quant="int8-hlo"``: a true int8 product, :class:`DenseInt8`), RoPE and
the normal init.

Activations run in bf16 (``COMPUTE`` dtype) from the embedding on; params
are fp32 masters.  ``dense`` casts a weight to the activation's dtype at
each call as the reference does; a caller may instead pass bf16 params
(``lm.init_params(..., dtype=COMPUTE)``), whose values are identical (the
cast is the same rounding, done once at load), so the cast here is then a
no-op.  Model code places activations with ``repro_torch.dist.sharding.
shard`` (the reference's ``models.common.shard``); beside a DTensor input
the RoPE tables are replicated on its mesh.
"""

from __future__ import annotations

from functools import partial

import torch

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist.sharding import (grad_placed_as, grad_placements,
                                       local_block, replicated_like)

COMPUTE = torch.bfloat16


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5):
    """RMSNorm in f32, rounded to x's dtype before the gain, as the
    reference: ``(x32 * scale).astype(dt) * gain.astype(dt)``.  On a
    DTensor its gradient comes back placed as its output
    (``dist.sharding.grad_placed_as``): the projections that read a normed
    input reduce their shares of its gradient there."""
    dt = x.dtype
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True)
                        + eps)
    return grad_placed_as((x32 * scale).to(dt) * gain.to(dt))


def fake_quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Dynamic symmetric per-tensor int8 fake-quant with a straight-through
    gradient (the reference's ``fake_quant_int8``), op for op in x's dtype:
    the scale ``max|x| / 127 + 1e-12`` rounded to it, a true division by
    that device tensor, ``torch.round`` (half to even), the clip to [-127,
    127], and ``x + (q - x).detach()`` — in bf16 each op rounds, so the
    value is not always ``q``, but it is the reference's."""
    s = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / s), -127, 127) * s
    return x + (q - x).detach()


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
          quant: str = "none") -> torch.Tensor:
    """``x @ w (+ b)`` in x's dtype, w in the ``(in, out)`` layout.
    ``quant="qat-int8"`` fake-quantizes x and w (w in its own dtype, the
    f32 master, before its cast) first; ``quant="int8-hlo"`` computes the
    product in int8 (:func:`dense_int8`)."""
    if quant == "int8-hlo":
        y = dense_int8(x, w.float())
    else:
        if quant == "qat-int8":
            x, w = fake_quantize_int8(x), fake_quantize_int8(w)
        elif quant != "none":
            raise ValueError(f"quant={quant!r}: 'none', 'qat-int8' or "
                             f"'int8-hlo'")
        y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def int8_scales(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """The reference's dynamic symmetric scales of ``_dense_int8_core``:
    ``sx = max|x| / 127 + 1e-12`` in x's dtype (0-d) and ``sw``, the same
    per output column of the f32 ``w`` (1, N); each divides by a device
    tensor (on CUDA a division by a Python scalar is a reciprocal
    multiply)."""
    def n127(ref):
        return replicated_like(torch.full((), 127.0, dtype=ref.dtype,
                                          device=ref.device), ref)
    ax = torch.max(torch.abs(x))
    aw = torch.amax(torch.abs(w), dim=0, keepdim=True)
    return ax / n127(ax) + 1e-12, aw / n127(aw) + 1e-12


def _quantize(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 through ``torch._int_mm``
    (cuBLASLt's int8 path on the card), zero-padded where the card's
    operator refuses the shape — M up to 17, K and N to multiples of 8 —
    on every device alike: zeros add nothing to an integer sum, so the
    product is exact."""
    m, k = xq.shape
    n = wq.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        xq = torch.nn.functional.pad(xq, (0, pk, 0, pm))
    if pk or pn:
        wq = torch.nn.functional.pad(wq, (0, pn, 0, pk))
    # w column-major: cuBLASLt's int8 path takes it ~5x faster than
    # row-major on an H100 (``chip_smoke.int8_product_times``)
    acc = torch._int_mm(xq.contiguous(), wq.t().contiguous().t())
    return acc[:m, :n] if pm or pn else acc


class DenseInt8(torch.autograd.Function):
    """The reference's ``_dense_int8_core`` given its scales: x (..., K) in
    its dtype and f32 w (K, N) quantized (true division, ``torch.round``
    half to even, the clip to [-127, 127]), the int8 product, its int32
    sums to f32 times ``sx * sw`` (f32), cast to x's dtype.  The backward
    is the straight-through estimator in the upstream gradient g's dtype:
    ``dx = g w^T``, ``dw = x^T g`` over every leading dim, cast to x's and
    w's dtypes.  The scales take no gradient."""

    @staticmethod
    def forward(ctx, x, w, sx, sw):
        ctx.save_for_backward(x, w)
        acc = int8_product(_quantize(x, sx).reshape(-1, x.shape[-1]),
                           _quantize(w, sw))
        y = acc.float() * (sx * sw)
        return y.reshape(*x.shape[:-1], w.shape[1]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.matmul(g, w.to(g.dtype).t())
        dw = torch.matmul(x.to(g.dtype).reshape(-1, x.shape[-1]).t(),
                          g.reshape(-1, g.shape[-1]))
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def dense_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as a true int8 product (``quant="int8-hlo"``), w f32.
    DTensors: the scales are DTensor reductions over the whole tensors (as
    the reference's SPMD program reduces them), then :class:`DenseInt8`
    runs per rank in ``local_map`` on x's rows (its features gathered) and
    w's output columns (its rows gathered); x's rows are gathered over a
    mesh dim that splits w's columns too."""
    with torch.no_grad():
        sx, sw = int8_scales(x.detach(), w.detach())
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return DenseInt8.apply(x, w, sx, sw)
    from torch.distributed.tensor.experimental import local_map
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    x, w = replicated_like(x, w), replicated_like(w, x)
    sx, sw = replicated_like(sx, w), replicated_like(sw, x)
    last = x.dim() - 1
    cols = [isinstance(p, Shard) and p.dim == 1 for p in w.placements]
    xp = [p if isinstance(p, Shard) and p.dim < last and not c
          else Replicate() for p, c in zip(x.placements, cols)]
    wp = [Shard(1) if c else Replicate() for c in cols]
    rep = [Replicate()] * mesh.ndim
    out = [Shard(last) if c else p for p, c in zip(xp, cols)]
    fn = local_map(DenseInt8.apply, out_placements=out,
                   in_placements=(xp, wp, rep, wp),
                   in_grad_placements=(grad_placements(xp, out),
                                       grad_placements(wp, out), rep, wp),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, w, sx, sw)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  For a DTensor table the lookup runs per rank in
    ``local_map`` with the vocab split as the table's is: each rank looks
    its tokens up in its own rows (:func:`_rows_of`, zero for a token of
    another rank's rows), the pieces are summed over the vocab's mesh dim,
    and the table's other dims are gathered.  The table's gradient stays
    split over the vocab and is pending over the dims that split the
    tokens (each rank holds its rows' share).  DTensor's own rule for the
    lookup's backward (``index_put``) fails on the card in torch 2.11
    under deterministic algorithms."""
    if not isinstance(table, DTensor):
        return table[tokens]
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    if len(vocab) > 1:
        raise ValueError(f"an embedding table split over {len(vocab)} mesh "
                         f"dims along its vocab {tuple(table.placements)}")
    tab = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    rows = [Replicate() if i in vocab else p
            for i, p in enumerate(tokens.placements)]
    out = [Partial() if i in vocab else p for i, p in enumerate(rows)]
    grad = [Shard(0) if i in vocab else
            Partial() if isinstance(p, Shard) else Replicate()
            for i, p in enumerate(rows)]
    _, offset = local_block(table.shape, mesh, tab)
    lookup = local_map(partial(_rows_of, offset=offset[0]),
                       out_placements=out, in_placements=(tab, rows),
                       in_grad_placements=(grad, rows), device_mesh=mesh)
    h = lookup(table.redistribute(mesh, tab), tokens.redistribute(mesh, rows))
    return h.redistribute(mesh, tokens.placements)


def _rows_of(table: torch.Tensor, ids: torch.Tensor, offset: int):
    """The rows of ``ids`` that fall in this rank's table (global rows
    ``offset`` on), zero for the others."""
    local = ids - offset
    own = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(own, local, 0)]
    return torch.where(own[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def rope_inv_freqs(head_dim: int, theta: float = 1e4,
                   device=None) -> torch.Tensor:
    """The RoPE inverse-frequency table ``(head_dim // 2,)`` in f32, made on
    ``device`` (a Python scalar base: no host-to-device copy)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, dh); positions broadcastable to (..., S).  Rotates the
    two halves of dh in f32 and casts back to x's dtype."""
    dh = x.shape[-1]
    freqs = rope_inv_freqs(dh, theta, device=x.device)
    angles = positions[..., None].float() * freqs         # (..., S, dh/2)
    cos = replicated_like(torch.cos(angles)[..., None, :], x)  # (.., S, 1, dh/2)
    sin = replicated_like(torch.sin(angles)[..., None, :], x)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def normal_init(generator: torch.Generator, shape, scale: float = 0.02,
                device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` in f32 (the reference's ``normal_init``)."""
    return scale * torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=device)

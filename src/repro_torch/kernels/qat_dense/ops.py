"""Public wrappers for the int8 dense kernels (counterpart of
``repro.kernels.qat_dense.ops``).

Three interchangeable implementations of the full-integer MRF network, all
bit-exact against the ``core.qat.int_forward`` oracle:

* :func:`int_forward_fused` — one launch of the whole-network CUDA kernel
  (``fused.fused_forward_call``) per voxel tile; weights packed once by
  :func:`prepad_int_layers`.
* :func:`int_forward_layered` — the per-layer CUDA GEMM chain
  (``kernel.qat_dense_call`` once per layer), the layered baseline.
* :func:`int_forward_lax` — plain PyTorch: fp32 matrix products wherever
  the layer magnitudes make fp32 accumulation exactly integral (see
  :func:`_f32_dot_is_exact`), exact float64 accumulation otherwise.

Plus :func:`qat_dense` (one ragged-shape int8 layer through the kernel) and
:func:`qat_dense_lax` (same contract, plain PyTorch).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.qat import quantize_input
from repro_torch.kernels.qat_dense.fused import fused_forward_call, pack_image
from repro_torch.kernels.qat_dense.kernel import qat_dense_call

# Integers with |v| < 2**24 are exactly representable in fp32; every partial
# sum of an int8 x int8 dot stays exact below this.
_F32_EXACT_LIMIT = float(2 ** 24)

#: K and N of the layered chain are padded to multiples of this, so that
#: every int8 activation row is a whole number of 32-bit words (B5 then
#: loads them 4 or 8 bytes at a time); the fused kernel's image pads
#: further, K to 32 and N to 8 (``fused.pack_image``)
PAD = 4


def _pad_to(x, m, axis):
    pad = (-x.shape[axis]) % m
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis) + 1] = pad  # F.pad counts from the last dim
    return torch.nn.functional.pad(x, widths)


def qat_dense(x_q, w_q, b_q, scale, *, relu: bool = True,
              float_out: bool = False):
    """Ragged-shape int8 dense layer. x_q (M,K) int8, w_q (K,N) int8,
    b_q (N,) int32, scale (N,) fp32 -> (M,N) int8 or fp32.  The kernel
    masks ragged edges, so nothing is padded."""
    return qat_dense_call(x_q.contiguous(), w_q.contiguous(),
                          b_q.contiguous(), scale.contiguous(), relu=relu,
                          float_out=float_out)


# ---------------------------------------------------------------------------
# Plain PyTorch path.
# ---------------------------------------------------------------------------

def _f32_dot_is_exact(k: int, b_absmax: float) -> bool:
    """True iff ``int8 @ int8 + b`` accumulates exactly in fp32.

    Products are bounded by 128*128 = 2**14; any summation order keeps every
    partial sum an integer of magnitude <= k * 2**14 + max|b|, and integer
    fp32 arithmetic is exact below 2**24.
    """
    return k * 16384.0 + b_absmax < _F32_EXACT_LIMIT


def _exact_acc(h, w_q, b_q, b_absmax: float):
    """fp32 accumulator of ``h @ w_q + b_q`` holding the exact integers."""
    if _f32_dot_is_exact(int(h.shape[-1]), b_absmax):
        return h.to(torch.float32) @ w_q.to(torch.float32) \
            + b_q.to(torch.float32)
    # fp32 would round: accumulate in float64 (exact below 2**53), which
    # also serves CUDA tensors, where PyTorch has no integer matmul
    acc = h.to(torch.float64) @ w_q.to(torch.float64) + b_q.to(torch.float64)
    return acc.to(torch.float32)


def qat_dense_lax(x_q, w_q, b_q, scale, *, relu: bool = True,
                  float_out: bool = False):
    """``qat_dense`` contract in plain PyTorch; bit-exact vs
    ``ref.ref_qat_dense`` for any shape."""
    bmax = float(b_q.abs().max()) if b_q.numel() else 0.0
    scaled = _exact_acc(x_q, w_q, b_q, bmax) * scale
    if float_out:
        return scaled
    lo = 0.0 if relu else -128.0
    return torch.clamp(torch.round(scaled), lo, 127.0).to(torch.int8)


def int_forward_lax(int_layers, x):
    """Full-integer MRF inference in plain PyTorch (cf. qat.int_forward).

    Hidden activations stay fp32 holding exact int8-range integers — values
    identical to the oracle's int8 tensors.
    """
    s = torch.as_tensor(int_layers[0].s_in, dtype=torch.float32,
                        device=x.device).reshape(1)
    h = torch.clamp(torch.round(x / s), -128.0, 127.0)
    for layer in int_layers:
        acc = _exact_acc(h, layer.w_q, layer.b_q, layer.b_absmax)
        if layer.s_out is None:
            h = acc * (layer.s_in * layer.s_w)
        else:
            requant = (layer.s_in * layer.s_w) / layer.s_out
            h = torch.clamp(torch.round(acc * requant), 0.0, 127.0)
    return h


# ---------------------------------------------------------------------------
# Pre-padded nets: the fused kernel's image and the layered chain's operands.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class PaddedInt8Net:
    """A full-integer net padded once, at artifact load, for the kernels.

    ``packed`` holds, per layer, ``w_p`` (Kp, Np) int8, ``b_p`` (Np,) int32
    and ``s_p`` (Np,) fp32 — requant multipliers for hidden layers, the
    head scale for the last — with Kp, Np multiples of :data:`PAD`.
    ``image`` is the same net as the fused kernel's shared-memory image
    (uint8 on the device); ``act_chunks`` its widest activation in 32-wide
    chunks.
    """

    packed: tuple          # flat (w_p, b_p, s_p) * n_layers, on the device
    s_in: torch.Tensor     # (1,) fp32 on the device — input activation scale
    s_in_host: float       # the same value, for the kernel's argument
    n_layers: int
    in_dim: int            # true (unpadded) fan-in of the first layer
    in_dim_p: int          # padded fan-in
    out_dim: int           # true fan-out of the head
    image: torch.Tensor
    act_chunks: int

    @property
    def padded_widths(self) -> tuple:
        return tuple(self.packed[3 * i].shape[1]
                     for i in range(self.n_layers))


def prepad_int_layers(int_layers) -> PaddedInt8Net:
    """Pad an ``Int8Layer`` list's K/N dims to :data:`PAD` multiples, once,
    and pack the fused kernel's image.

    Zero padding is arithmetic-neutral through the whole net: padded weight
    columns yield zero accumulators, zero bias, zero scale -> zero
    activations, which then meet zero weight *rows* in the next layer.  The
    per-layer scale is computed on the host in fp32 with the oracle's
    operand grouping (``(s_in * s_w) / s_out``), so the kernels' fp32 math
    is bit-identical.
    """
    dev = int_layers[0].w_q.device
    packed = []
    for layer in int_layers:
        s_in = np.float32(layer.s_in.cpu())
        s_w = layer.s_w.cpu().numpy().astype(np.float32)
        if layer.s_out is None:
            scale = s_in * s_w
        else:
            scale = (s_in * s_w) / np.float32(layer.s_out.cpu())
        wp = _pad_to(_pad_to(layer.w_q, PAD, 0), PAD, 1).contiguous()
        bp = _pad_to(layer.b_q, PAD, 0).contiguous()
        sp = _pad_to(torch.from_numpy(scale.astype(np.float32)).to(dev),
                     PAD, 0).contiguous()
        packed.extend((wp, bp, sp))
    image, act_chunks = pack_image(packed)
    s_in_host = float(np.float32(int_layers[0].s_in.cpu()))
    return PaddedInt8Net(
        packed=tuple(packed),
        s_in=torch.tensor([s_in_host], dtype=torch.float32, device=dev),
        s_in_host=s_in_host, n_layers=len(int_layers),
        in_dim=int(int_layers[0].w_q.shape[0]),
        in_dim_p=int(packed[0].shape[0]),
        out_dim=int(int_layers[-1].w_q.shape[1]),
        image=torch.from_numpy(image).to(dev), act_chunks=act_chunks)


def int_forward_fused(net, x, *, denorm_scale=None):
    """Whole-network fused int8 inference from fp32 features.

    ``net``: a :class:`PaddedInt8Net` (an ``Int8Layer`` list is packed on
    the fly).  ``denorm_scale``: optional (out_dim,) fp32 row multiplied
    after the head scale inside the kernel.
    """
    if not isinstance(net, PaddedInt8Net):
        net = prepad_int_layers(net)
    drow = None
    if denorm_scale is not None:
        drow = torch.as_tensor(denorm_scale, dtype=torch.float32,
                               device=x.device).contiguous()
    return fused_forward_call(x.to(torch.float32).contiguous(), net,
                              drow=drow)


def int_forward_layered(net, x):
    """Full-integer inference through the per-layer kernel chain (the
    counterpart of ``repro.kernels.qat_dense.ops.int_forward_pallas``).

    Activations stay on the padded widths between layers; only the input
    is padded, once.
    """
    if not isinstance(net, PaddedInt8Net):
        net = prepad_int_layers(net)
    h = _pad_to(quantize_input(x, net.s_in), PAD, 1).contiguous()
    for i in range(net.n_layers):
        wp, bp, sp = net.packed[3 * i:3 * i + 3]
        last = i == net.n_layers - 1
        h = qat_dense_call(h, wp, bp, sp, relu=not last, float_out=last)
    return h[:, :net.out_dim]

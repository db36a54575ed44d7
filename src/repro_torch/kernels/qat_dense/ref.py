"""Plain PyTorch versions of the two int8 kernels.

``ref_qat_dense`` is the plain version of ``qat_dense.cu`` (the JAX
package's ``ref.ref_qat_dense``); ``ref_fused_forward`` the plain version
of ``fused_forward.cu``.  They run on the CPU and on the card, which is how
``chip_smoke.py`` holds each kernel against them on identical tensors.

Integer products are accumulated in float64 and converted to int32: every
product of two int8 values is an integer below 2**14 in magnitude, so any
sum of fewer than 2**39 of them is exact in float64, in any order, on
either device (CUDA PyTorch has no integer matrix product).
"""

from __future__ import annotations

import torch


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of two int8 (or int8-valued) matrices."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def ref_qat_dense(x_q, w_q, b_q, scale, *, relu: bool = True,
                  float_out: bool = False):
    """(M,K) int8 @ (K,N) int8 + (N,) int32, x (N,) fp32 -> int8 or fp32."""
    acc = int_matmul(x_q, w_q) + b_q.to(torch.int32)
    scaled = acc.to(torch.float32) * scale
    if float_out:
        return scaled
    y = torch.round(scaled)
    lo = 0.0 if relu else -128.0
    return torch.clamp(y, lo, 127.0).to(torch.int8)


def ref_fused_forward(x, s_in, packed, out_dim: int, drow=None):
    """The whole int8 net from fp32 features, op for op as the oracle.

    ``packed``: per layer ``(w (K,N) int8, b (N,) int32, s (N,) fp32)`` —
    requant multipliers on hidden layers, the head scale on the last.
    ``x`` (M, K0) may have fewer columns than the first layer's K (the
    padding rows meet zero activations).  Returns (M, out_dim) fp32,
    multiplied by ``drow`` (out_dim,) after the head scale when given.
    """
    s = torch.as_tensor(s_in, dtype=torch.float32, device=x.device).reshape(1)
    h = torch.clamp(torch.round(x / s), -128.0, 127.0)
    k0 = packed[0].shape[0]
    if h.shape[1] < k0:
        h = torch.nn.functional.pad(h, (0, k0 - h.shape[1]))
    n_layers = len(packed) // 3
    for i in range(n_layers):
        w, b, sc = packed[3 * i:3 * i + 3]
        scaled = (int_matmul(h, w) + b).to(torch.float32) * sc
        if i == n_layers - 1:
            h = scaled[:, :out_dim]
        else:
            h = torch.clamp(torch.round(scaled), 0.0, 127.0)
    return h if drow is None else h * drow

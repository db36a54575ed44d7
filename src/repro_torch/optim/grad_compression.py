"""Int8 error-feedback gradient compression (counterpart of
``repro.optim.grad_compression``): what a cross-pod gradient all-reduce
would carry.  Each step the gradient, plus the residual the last step's
quantization left, is quantized to int8 with one symmetric scale a tensor
and dequantized; the new residual is what that lost.  On one card there is
no exchange, so this is the numerics of the wire and nothing else.

The operations and their order are the reference's: ``max |g| / 127 +
1e-12``, a true division, round half to even (``torch.round``), clip to
[-127, 127], multiply back.  ``int8_roundtrip`` is the reference's
``int8_compress_decompress``, renamed: the reference's dead-exports
allowlist holds that name.

A DTensor gradient (``launch.train --mesh``) is compressed by DTensor's
own ops: the max of a split leaf is reduced over its ranks, so each
leaf's scale is the whole leaf's, as the reference's jitted step computes
it on the global gradient (a per-shard scale would be another
compression); the step compresses after the gradient is reduced onto its
parameter's placements, and the residual keeps them.
"""

from __future__ import annotations

import torch

from repro_torch.tree import leaves, rebuild, tree_map


def int8_roundtrip(g: torch.Tensor) -> tuple:
    """(dequantized, residual) of one tensor quantized to int8 with a
    symmetric per-tensor scale: exactly what the wire would see."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127)
    deq = q * scale
    return deq, g - deq


def error_feedback_compress(grads, residuals):
    """Error feedback + int8 compression of a gradient tree.  ``residuals``
    is a tree like ``grads`` (carried in ``TrainState.ef_residual``), or
    None for zeros.  Returns (compressed grads, new residuals)."""
    if residuals is None:
        residuals = tree_map(torch.zeros_like, grads)
    corrected = tree_map(torch.add, grads, residuals)
    out = [int8_roundtrip(g) for g in leaves(corrected)]
    return (rebuild(grads, [o[0] for o in out]),
            rebuild(grads, [o[1] for o in out]))

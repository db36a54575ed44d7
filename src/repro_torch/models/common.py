"""Shared LM components (counterpart of ``repro.models.common``): RMSNorm,
the dense projection with the paper's int8 QAT (``quant="qat-int8"``:
:func:`fake_quantize_int8` on both operands), RoPE and the normal init.

Activations run in bf16 (``COMPUTE`` dtype) from the embedding on; params
are fp32 masters.  ``dense`` casts a weight to the activation's dtype at
each call as the reference does; a caller may instead pass bf16 params
(``lm.init_params(..., dtype=COMPUTE)``), whose values are identical (the
cast is the same rounding, done once at load), so the cast here is then a
no-op.  ``shard`` is the identity on one card and is
left out.
"""

from __future__ import annotations

import torch

COMPUTE = torch.bfloat16


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5):
    """RMSNorm in f32, rounded to x's dtype before the gain, as the
    reference: ``(x32 * scale).astype(dt) * gain.astype(dt)``."""
    dt = x.dtype
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True)
                        + eps)
    return (x32 * scale).to(dt) * gain.to(dt)


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
    f32 master, before its cast) first."""
    if quant == "qat-int8":
        x, w = fake_quantize_int8(x), fake_quantize_int8(w)
    elif quant != "none":
        raise NotImplementedError(
            f"quant={quant!r} (int8 dots) waits for the dry-run slice, its "
            f"only entry point in the reference (ROADMAP.md §A 5)")
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


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
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def normal_init(generator: torch.Generator, shape, scale: float = 0.02,
                device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` in f32 (the reference's ``normal_init``)."""
    return scale * torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=device)

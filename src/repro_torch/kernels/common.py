"""Shared helpers for kernel wrappers and entry points: device resolution and
the int8 implementation choice.

Devices are explicit.  ``resolve_device("cuda")`` raises when there is no
CUDA card instead of quietly running on the CPU; callers that mean the CPU
say ``device="cpu"``.
"""

from __future__ import annotations

import torch

INT8_IMPL_CHOICES = ("fused", "lax", "layered")


def resolve_int8_impl(impl: str | None) -> str:
    """Pick the int8 serving implementation; ``None`` means ``"fused"``.

    ``"fused"`` is the whole-network CUDA kernel (``fused_forward.cu``),
    ``"layered"`` the per-layer CUDA GEMM chain (``qat_dense.cu``) and
    ``"lax"`` the plain PyTorch forward.  On the CPU every implementation
    runs its plain PyTorch version; all are bit-exact against
    ``core.qat.int_forward``.
    """
    if impl is None:
        return "fused"
    if impl not in INT8_IMPL_CHOICES:
        raise ValueError(f"int8 impl {impl!r} not in {INT8_IMPL_CHOICES}")
    return impl


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card.

    Only ``cpu`` and ``cuda`` devices are accepted.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                f"available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device {str(device)!r}: only cpu and cuda are "
                         f"supported")
    return dev


def disable_tf32() -> None:
    """Keep fp32 matrix products and convolutions in full fp32 on the card.

    The plain ``lax`` and ``float`` paths compare against fp32 references;
    TF32 keeps about three decimal digits.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

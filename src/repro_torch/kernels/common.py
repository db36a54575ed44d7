"""Shared helpers for kernel wrappers and entry points: device resolution and
the int8 implementation choice.

Devices are explicit.  ``resolve_device("cuda")`` raises when there is no
CUDA card instead of quietly running on the CPU; callers that mean the CPU
say ``device="cpu"``.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

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


def resolve_device(device, *, meta: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card.

    Only ``cpu`` and ``cuda`` devices are accepted, and with ``meta=True``
    the meta device (shapes without storage: ``launch.input_specs``).
    """
    dev = torch.device(device)
    if meta and dev.type == "meta":
        return dev
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


def refuse_grad(what: str, *tensors) -> None:
    """Raise if a gradient could reach a kernel whose output has none: grad
    enabled and an input that requires it.  The port's ctypes wrappers fill
    outputs that the autograd graph does not see, so the gradient would be
    cut silently and a different model trained.  B1-B5 compute no
    gradient on either device and check on the CPU too; B6's wrapper
    checks CUDA tensors (its plain version differentiates on the CPU)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and the kernel's output has no "
            f"backward; call it under torch.no_grad() (or on detached "
            f"inputs) where no gradient is wanted")


def refuse_dtensor(what: str, *tensors) -> None:
    """Raise if a DTensor reaches a kernel wrapper: the ctypes launch reads
    a local buffer and would compute on one rank's shard as if it were the
    whole tensor.  Inside a sharded region each kernel call is wrapped in
    ``torch.distributed.tensor.experimental.local_map`` (or an explicit
    ``to_local`` / ``DTensor.from_local`` with stated placements) over the
    rank's local shard."""
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                f"{what}: got a DTensor (placements {tuple(t.placements)}); "
                f"kernel wrappers take local tensors. Wrap the call in "
                f"local_map (torch.distributed.tensor.experimental) over the "
                f"rank's local shard")

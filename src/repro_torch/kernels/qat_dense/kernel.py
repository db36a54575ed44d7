"""Wrapper of the int8 dense CUDA kernel (``csrc/qat_dense.cu``), the port of
``repro.kernels.qat_dense.kernel.qat_dense_call``.

Int8 x int8 -> int32 dense layer on the int8 tensor cores with the fused
epilogue (bias, fp32 rescale, round half to even, clamp to int8 — or fp32
out for the float head), bit-exact against ``ref.ref_qat_dense``.  The
kernel masks ragged M/N/K edges itself, so no operand is padded.  Each
block holds a (K, slab) slice of the weights in shared memory
(:func:`smem_bytes`); a K whose slice does not fit is refused.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  ``qat_dense_call.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import refuse_dtensor, refuse_grad
from repro_torch.kernels.qat_dense.ref import ref_qat_dense


def smem_bytes(k: int, n: int) -> int:
    """Shared memory of a launch (``slab_smem`` in the .cu): the block's
    weight slab of 16, 32 or 64 columns (the narrowest that covers N, up
    to 64) as B fragments, K padded to 32, plus the slab's bias and
    scale."""
    n16 = -(-n // 16)
    nt = 2 * (1 if n16 <= 1 else 2 if n16 == 2 else 4)
    return -(-k // 32) * nt * 256 + 64 * nt


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("qat_dense").qat_dense_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x_q, w_q, b_q, scale):
    dev = x_q.device
    for name, t, dtype, ndim in (("x_q", x_q, torch.int8, 2),
                                 ("w_q", w_q, torch.int8, 2),
                                 ("b_q", b_q, torch.int32, 1),
                                 ("scale", scale, torch.float32, 1)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x_q on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name}: want {ndim}-d {dtype}, got "
                             f"{t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = x_q.shape
    if w_q.shape[0] != k or b_q.shape[0] != w_q.shape[1] \
            or scale.shape[0] != w_q.shape[1]:
        raise ValueError(f"shape mismatch: x {tuple(x_q.shape)}, w "
                         f"{tuple(w_q.shape)}, b {tuple(b_q.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if smem_bytes(k, w_q.shape[1]) > build.SMEM_MAX:
        raise ValueError(f"K={k} is too deep for the kernel's weight slab "
                         f"({smem_bytes(k, w_q.shape[1])} B of shared memory, "
                         f"{build.SMEM_MAX} B a block)")


def qat_dense_call(x_q, w_q, b_q, scale, *, relu: bool = True,
                   float_out: bool = False):
    """x_q (M,K) int8, w_q (K,N) int8, b_q (N,) int32, scale (N,) fp32 ->
    (M,N) int8 (requantized, ReLU-clamped when ``relu``) or fp32
    (``float_out``, the linear head).  Computes no gradient: raises under
    grad for an input that requires one, on either device."""
    refuse_dtensor("qat_dense_call", x_q, w_q, b_q, scale)
    refuse_grad("qat_dense_call", x_q, w_q, b_q, scale)
    if x_q.device.type == "cpu":
        return ref_qat_dense(x_q, w_q, b_q, scale, relu=relu,
                             float_out=float_out)
    if x_q.device.type != "cuda":
        raise ValueError(f"qat_dense_call: unsupported device {x_q.device}")
    _check(x_q, w_q, b_q, scale)
    build.check_device(x_q.device)
    m, k = x_q.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), device=x_q.device,
                      dtype=torch.float32 if float_out else torch.int8)
    if m == 0 or n == 0:
        return out  # nothing to launch, nothing to count
    err = _entry()(x_q.data_ptr(), w_q.data_ptr(), b_q.data_ptr(),
                   scale.data_ptr(), out.data_ptr(), m, n, k, int(relu),
                   int(float_out),
                   torch.cuda.current_stream(x_q.device).cuda_stream)
    if err:
        raise RuntimeError(f"qat_dense kernel launch failed: CUDA error {err}")
    qat_dense_call.launches += 1
    return out


qat_dense_call.launches = 0

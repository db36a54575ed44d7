"""Wrapper of the fused whole-network int8 CUDA kernel
(``csrc/fused_forward.cu``), the port of
``repro.kernels.qat_dense.fused.fused_forward_call``.

One launch per voxel tile runs the entire full-integer net: input
quantization, per-layer int8 dot + bias + fp32 requantize with the ReLU
fused into the [0, 127] clamp, the float head and an optional denormalize
row — bit-exact against ``core.qat.int_forward`` (and ``ref_fused_forward``).

:func:`pack_image` lays the net out once, at artifact load, as the single
buffer each block copies into shared memory.  A CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises.
``fused_forward_call.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.qat_dense.ref import ref_fused_forward

_HEADER_INTS = 4     # per layer: k_words, n, w_offset, bs_offset (words)
_VOXELS = 8          # voxels per block (kVoxels in the .cu)
_SMEM_MAX = 232_448  # bytes of shared memory a block may use on sm_90


def pack_image(packed) -> tuple:
    """The kernel's shared-memory image of a padded net.

    ``packed``: per layer ``(w (K,N) int8, b (N,) int32, s (N,) fp32)``
    with K and N multiples of 4.  Returns ``(image, act_words)``: a uint8
    numpy buffer (a 16-byte multiple) holding the per-layer header, the
    weights transposed to (N, K) rows of 32-bit words — each row followed
    by one zero word, which staggers the rows across shared-memory banks —
    biases and scales; and the widest activation in 32-bit words.
    """
    n_layers = len(packed) // 3
    header = np.zeros(_HEADER_INTS * n_layers, np.int32)
    words = [header]
    offset = header.size
    act_words = 0
    for i in range(n_layers):
        w, b, s = (np.asarray(t.detach().cpu()) for t in packed[3 * i:3 * i + 3])
        k, n = w.shape
        if k % 4 or n % 4:
            raise ValueError(f"layer {i}: K={k}, N={n} must be multiples of 4")
        w_words = np.zeros((n, k // 4 + 1), np.int32)
        w_words[:, :k // 4] = np.ascontiguousarray(w.T).view(np.int32)
        w_words = w_words.reshape(-1)
        bs = np.concatenate([b.astype(np.int32),
                             s.astype(np.float32).view(np.int32)])
        header[_HEADER_INTS * i:_HEADER_INTS * (i + 1)] = (
            k // 4, n, offset, offset + w_words.size)
        words += [w_words, bs]
        offset += w_words.size + bs.size
        act_words = max(act_words, k // 4, n // 4)
    image = np.concatenate(words)
    image = np.concatenate([image, np.zeros((-image.size) % 4, np.int32)])
    return image.view(np.uint8), act_words


def smem_bytes(image_bytes: int, act_words: int) -> int:
    """Dynamic shared memory of one launch: the image + two activation
    buffers of ``act_words`` words per voxel."""
    return image_bytes + 2 * act_words * _VOXELS * 4


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("fused_forward").fused_forward_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_forward_call(x, net, *, drow=None):
    """x (M, in_dim) fp32 -> (M, out_dim) fp32 through the whole net.

    ``net``: an ``ops.PaddedInt8Net``.  ``drow``: optional (out_dim,) fp32
    row multiplied after the head scale (the serving engine's
    denormalization, fused).
    """
    if x.device.type == "cpu":
        return ref_fused_forward(x, net.s_in, net.packed, net.out_dim,
                                 drow=drow)
    if x.device.type != "cuda":
        raise ValueError(f"fused_forward_call: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-d float32 tensor, got "
                         f"{x.dim()}-d {x.dtype}")
    if x.shape[1] != net.in_dim:
        raise ValueError(f"x has {x.shape[1]} features, net takes "
                         f"{net.in_dim}")
    if net.image.device != x.device:
        raise ValueError(f"net on {net.image.device}, x on {x.device}")
    if drow is not None and (drow.device != x.device
                             or drow.dtype != torch.float32
                             or drow.shape != (net.out_dim,)
                             or not drow.is_contiguous()):
        raise ValueError(f"drow must be a contiguous ({net.out_dim},) float32 "
                         f"tensor on {x.device}")
    if smem_bytes(net.image.numel(), net.act_words) > _SMEM_MAX:
        raise ValueError("net too large for the fused kernel's shared memory")
    build.check_device(x.device)
    m = x.shape[0]
    out = torch.empty((m, net.out_dim), dtype=torch.float32, device=x.device)
    if m == 0:
        return out  # nothing to launch, nothing to count
    err = _entry()(x.data_ptr(), m, net.in_dim, net.s_in_host,
                   net.image.data_ptr(), net.image.numel(), net.n_layers,
                   net.act_words, None if drow is None else drow.data_ptr(),
                   out.data_ptr(), net.out_dim,
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_forward kernel launch failed: CUDA error "
                           f"{err}")
    fused_forward_call.launches += 1
    return out


fused_forward_call.launches = 0

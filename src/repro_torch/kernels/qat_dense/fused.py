"""Wrapper of the fused whole-network int8 CUDA kernel
(``csrc/fused_forward.cu``), the port of
``repro.kernels.qat_dense.fused.fused_forward_call``.

One launch per voxel tile runs the entire full-integer net: input
quantization, per-layer int8 dot + bias + fp32 requantize with the ReLU
fused into the [0, 127] clamp, the float head and an optional denormalize
row — bit-exact against ``core.qat.int_forward`` (and ``ref_fused_forward``).

:func:`pack_image` lays the net out once, at artifact load, as the single
buffer each block copies into shared memory, its weights already in the
order the kernel's tensor-core fragments read them.  A CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises.
``fused_forward_call.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import refuse_dtensor, refuse_grad
from repro_torch.kernels.qat_dense.ref import ref_fused_forward

_HEADER_INTS = 4     # per layer: k_chunks, n_tiles, frag_offset, bs_offset
_MAX_CHUNKS = 8      # widest activation the kernel carries, in 32-wide chunks


def k_map(chain: bool) -> np.ndarray:
    """``phys[t, h, q]``: the weight row, within a 32-wide k chunk, that
    byte ``q`` of half ``h`` of lane ``t``'s A and B registers stands for
    (``csrc/int8_mma.cuh``).  The first layer takes the kInput map (a
    lane's eight features of a row are contiguous); the others the kChain
    map (the columns a lane holds in the previous layer's accumulators)."""
    t, h, q = np.meshgrid(np.arange(4), np.arange(2), np.arange(4),
                          indexing="ij")
    if chain:
        return 16 * h + 8 * (q >> 1) + 2 * t + (q & 1)
    return 8 * t + 4 * h + q


def fragments(w: np.ndarray, chain: bool) -> np.ndarray:
    """``w`` (K, N) int8 as mma.m16n8k32 B fragments in fragment order,
    K padded to 32 and N to 8 with zeros: int32 word
    ``((kc * nt + j) * 32 + lane) * 2 + h`` holds rows ``32 kc +
    k_map(chain)[t, h, :]`` of column ``8 j + g``, lane = 4 g + t."""
    k, n = w.shape
    kp, n_p = -(-k // 32) * 32, -(-n // 8) * 8
    wp = np.zeros((kp, n_p), np.int8)
    wp[:k, :n] = w
    kc = np.arange(kp // 32).reshape(-1, 1, 1, 1, 1, 1)
    j = np.arange(n_p // 8).reshape(1, -1, 1, 1, 1, 1)
    g = np.arange(8).reshape(1, 1, -1, 1, 1, 1)
    rows = 32 * kc + k_map(chain)[None, None, None]  # (kch, 1, 1, 4, 2, 4)
    return np.ascontiguousarray(wp[rows, 8 * j + g]).view(np.int32).reshape(-1)


def pack_image(packed) -> tuple:
    """The kernel's shared-memory image of a padded net.

    ``packed``: per layer ``(w (K,N) int8, b (N,) int32, s (N,) fp32)``,
    each layer's K the previous layer's N.  Returns ``(image,
    act_chunks)``: a uint8 numpy buffer (a 16-byte multiple) holding the
    per-layer header ``(k_chunks, n_tiles, frag_offset, bs_offset)`` (in
    32-bit words), each layer's :func:`fragments` (the first layer on the
    kInput map, the others on the kChain map), then its biases and scales
    padded to ``8 n_tiles`` with zeros; and the widest activation in
    32-wide chunks.  Zero padding is exact: a padded column has zero
    weights, bias and scale, so its activation is 0, and it meets zero
    weight rows in the next layer.
    """
    n_layers = len(packed) // 3
    header = np.zeros(_HEADER_INTS * n_layers, np.int32)
    words = [header]
    offset = header.size
    act_chunks = 0
    for i in range(n_layers):
        w, b, s = (np.asarray(t.detach().cpu()) for t in packed[3 * i:3 * i + 3])
        k, n = w.shape
        if i and k != packed[3 * i - 3].shape[1]:
            raise ValueError(f"layer {i}: K={k} is not the previous layer's N")
        frags = fragments(w, chain=i > 0)
        kch, nt = -(-k // 32), -(-n // 8)
        bs = np.zeros(16 * nt, np.int32)
        bs[:n] = b.astype(np.int32)
        bs[8 * nt:8 * nt + n] = s.astype(np.float32).view(np.int32)
        header[_HEADER_INTS * i:_HEADER_INTS * (i + 1)] = (
            kch, nt, offset, offset + frags.size)
        words += [frags, bs]
        offset += frags.size + bs.size
        act_chunks = max(act_chunks, kch, -(-nt // 4))
    image = np.concatenate(words)
    image = np.concatenate([image, np.zeros((-image.size) % 4, np.int32)])
    return image.view(np.uint8), act_chunks


def smem_bytes(image_bytes: int, act_chunks: int) -> int:
    """The most shared memory a launch's block takes: the image, its 8-byte
    mbarrier, and two exchange buffers of ``C * 4`` n8 tiles x 32 lanes x
    4 bytes for each of up to 8 warp groups (``C``: the kernel
    instantiation's 2, 4 or 8 chunks)."""
    c = next(c for c in (2, 4, 8, act_chunks) if c >= act_chunks)
    return image_bytes + 8 + 8 * 2 * c * 512


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
    denormalization, fused).  Computes no gradient: raises under grad for
    an input that requires one, on either device.
    """
    refuse_dtensor("fused_forward_call", x, drow)
    refuse_grad("fused_forward_call", x, drow)
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
    if smem_bytes(net.image.numel(), net.act_chunks) > build.SMEM_MAX:
        raise ValueError("net too large for the fused kernel's shared memory")
    if net.act_chunks > _MAX_CHUNKS:
        raise ValueError(f"a layer is wider than {32 * _MAX_CHUNKS}: the "
                         f"fused kernel carries at most {_MAX_CHUNKS} chunks")
    build.check_device(x.device)
    m = x.shape[0]
    out = torch.empty((m, net.out_dim), dtype=torch.float32, device=x.device)
    if m == 0:
        return out  # nothing to launch, nothing to count
    err = _entry()(x.data_ptr(), m, net.in_dim, net.s_in_host,
                   net.image.data_ptr(), net.image.numel(), net.n_layers,
                   net.act_chunks, None if drow is None else drow.data_ptr(),
                   out.data_ptr(), net.out_dim,
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_forward kernel launch failed: CUDA error "
                           f"{err}")
    fused_forward_call.launches += 1
    return out


fused_forward_call.launches = 0

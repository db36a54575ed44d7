"""Wrapper of the flash-attention CUDA kernels, the port of
``repro.kernels.flash_attn.kernel.flash_attention_call`` (B6): bf16 runs the
Hopper kernel (``csrc/flash_attn_sm90.cu``: wgmma, TMA, q tiles of 128 rows,
kv tiles of :func:`bf16_tiles`), float32 the scalar kernel
(``csrc/flash_attn.cu``: tiles of at most 64 rows).

Forward attention with an online softmax over kv blocks: causal,
sliding-window and kv-length masks, kv blocks that the causal or window
rule masks for a whole q block skipped, GQA query head ``bh`` reading kv
head ``bh // group``.  Same layout and contract as the TPU kernel: q
(BH, Sq, dh), k/v (BH // group, Sk, dh), sequences padded to block
multiples (``ops.flash_attention`` pads), ``kv_len`` the true kv length.

A CPU tensor runs the plain version (``ref.flash_attention_plain``); a CUDA
tensor launches the kernel of its dtype or raises: a bf16 input with a tile
or a head dim that the Hopper kernel does not take is refused, never sent
to the scalar kernel.  ``flash_attention_call.launches`` counts kernel
launches of both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn.ref import flash_attention_plain

MAX_BLOCK = 64      # the float32 kernel's largest q and kv tile (rows)
MAX_HEAD_DIM = 128
BF16_HEAD_DIMS = (16, 32, 64, 128)   # the bf16 kernel's template instances
_GRID_Y_MAX = 65535  # CUDA's limit on gridDim.y (the float32 kernel's heads)
_INT_MAX = 2 ** 31 - 1
_TENSOR_MAP_ERRORS = 10000  # flash_attn_sm90.cu: kNoEntryPoint, kEncodeFailed
_DTYPES = (torch.float32, torch.bfloat16)


def bf16_tiles(dh: int) -> tuple:
    """(block_q, block_k) of the bf16 kernel at head dim ``dh``: q tiles of
    128 rows (two wgmma warpgroups of 64), kv tiles of 128 rows, or 64 at
    dh 128 (a fresh 64 x 128 f32 P V accumulator beside acc leaves no
    registers for a 64 x 128 score tile)."""
    return 128, 128 if dh <= 64 else 64


def default_blocks(dtype, dh: int) -> tuple:
    """The tiles a call takes when it names none: the bf16 kernel's, or
    64 x 64 for the float32 kernel."""
    return bf16_tiles(dh) if dtype == torch.bfloat16 else (64, 64)


@functools.lru_cache(maxsize=None)
def _entry(bf16: bool):
    if bf16:
        fn = build.load("flash_attn_sm90").flash_attn_sm90_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
    else:
        fn = build.load("flash_attn").flash_attn_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, block_q, block_k, group, kv_len):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_call: dtype {q.dtype} (float32 or "
                         f"bfloat16 only)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-d tensor")
    bh, sq, dh = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    if k.shape[2] != dh or v.shape != k.shape or bh != bkv * group:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, group {group}")
    if q.dtype == torch.bfloat16:
        if dh not in BF16_HEAD_DIMS:
            raise ValueError(f"head dim {dh}: the bf16 kernel takes "
                             f"{BF16_HEAD_DIMS}")
        tiles = bf16_tiles(dh)
        if (block_q, block_k) != tiles:
            raise ValueError(f"block_q={block_q}, block_k={block_k}: the bf16 "
                             f"kernel takes only {tiles} at dh {dh}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned (TMA)")
        if sk == 0:
            raise ValueError("no keys: the bf16 kernel needs sk > 0")
        if bh * sq > _INT_MAX or bkv * sk > _INT_MAX:
            raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: rows "
                             f"beyond the tensor maps' 32-bit coordinates")
    else:
        if not 0 < dh <= MAX_HEAD_DIM:
            raise ValueError(f"head dim {dh} outside (0, {MAX_HEAD_DIM}]")
        for name, blk in (("block_q", block_q), ("block_k", block_k)):
            if not 0 < blk <= MAX_BLOCK:
                raise ValueError(f"{name}={blk}: the float32 kernel takes "
                                 f"(0, {MAX_BLOCK}]")
        if bh > _GRID_Y_MAX:
            raise ValueError(f"{bh} heads exceed the kernel's grid "
                             f"({_GRID_Y_MAX})")
    for name, blk, s in (("block_q", block_q, sq), ("block_k", block_k, sk)):
        if s % blk:
            raise ValueError(f"{name}={blk} does not divide the padded "
                             f"length {s}")
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} outside [0, {sk}]")


def flash_attention_call(q, k, v, *, causal: bool = True, window: int = 0,
                         block_q: int | None = None,
                         block_k: int | None = None, group: int = 1,
                         kv_len: int | None = None, scores=None):
    """q: (BH, Sq, dh); k/v: (BH // group, Sk, dh), f32 or bf16, seqs padded
    to block multiples; blocks default to :func:`default_blocks`;
    ``kv_len`` = true kv length.  Returns (BH, Sq, dh) in q's dtype.

    ``scores``, for checks only (bf16 on the card): a contiguous float32
    (BH, Sq, Sk) tensor that receives the kernel's scaled scores of every kv
    tile it runs (``ref.flash_attention_plain(scores=...)`` takes them)."""
    dq, dk = default_blocks(q.dtype, q.shape[-1])
    block_q = dq if block_q is None else block_q
    block_k = dk if block_k is None else block_k
    if q.device.type == "cpu":
        if scores is not None:
            raise ValueError("scores: the kernel's, on the card only")
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k,
                                     group=group, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_call: unsupported device "
                         f"{q.device}")
    kv_len = k.shape[1] if kv_len is None else kv_len
    _check(q, k, v, block_q, block_k, group, kv_len)
    if scores is not None and (
            q.dtype != torch.bfloat16 or scores.device != q.device
            or scores.dtype != torch.float32 or not scores.is_contiguous()
            or scores.shape != (q.shape[0], q.shape[1], k.shape[1])):
        raise ValueError("scores: a contiguous float32 (BH, Sq, Sk) tensor "
                         "beside bf16 inputs on the same card")
    build.check_device(q.device)
    bh, sq, dh = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out  # nothing to launch, nothing to count
    args = (bh, sq, k.shape[1], dh, group, kv_len, int(causal), int(window))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        err = _entry(True)(*ptrs, None if scores is None
                           else scores.data_ptr(), *args, stream)
    else:
        err = _entry(False)(*ptrs, *args, block_q, block_k, stream)
    if err >= _TENSOR_MAP_ERRORS:
        raise RuntimeError(f"flash_attn_sm90: no TMA tensor map (code {err}: "
                           f"10000 no driver entry point, 20000 + CUresult "
                           f"refused)")
    if err:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {err}")
    flash_attention_call.launches += 1
    return out


flash_attention_call.launches = 0

"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attn.cu``), the
port of ``repro.kernels.flash_attn.kernel.flash_attention_call`` (B6).

Forward attention with an online softmax over kv blocks: causal,
sliding-window and kv-length masks, kv blocks that the causal or window
rule masks for a whole q block skipped, GQA query head ``bh`` reading kv
head ``bh // group``.  Same layout and contract as the TPU kernel: q
(BH, Sq, dh), k/v (BH // group, Sk, dh), sequences padded to block
multiples (``ops.flash_attention`` pads), ``kv_len`` the true kv length.

A CPU tensor runs the plain version (``ref.flash_attention_plain``); a CUDA
tensor launches the kernel or raises.  ``flash_attention_call.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn.ref import flash_attention_plain

MAX_BLOCK = 64      # the kernel's q and kv tile (rows)
MAX_HEAD_DIM = 128
_GRID_Y_MAX = 65535  # CUDA's limit on gridDim.y (one row of blocks per head)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_attn").flash_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + \
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
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside (0, {MAX_HEAD_DIM}]")
    for name, blk, s in (("block_q", block_q, sq), ("block_k", block_k, sk)):
        if not 0 < blk <= MAX_BLOCK or s % blk:
            raise ValueError(f"{name}={blk}: must be in (0, {MAX_BLOCK}] and "
                             f"divide the padded length {s}")
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} outside [0, {sk}]")
    if bh > _GRID_Y_MAX:
        raise ValueError(f"{bh} heads exceed the kernel's grid ({_GRID_Y_MAX})")


def flash_attention_call(q, k, v, *, causal: bool = True, window: int = 0,
                         block_q: int = 64, block_k: int = 64,
                         group: int = 1, kv_len: int | None = None):
    """q: (BH, Sq, dh); k/v: (BH // group, Sk, dh), f32 or bf16, seqs padded
    to block multiples; ``kv_len`` = true kv length.  Returns (BH, Sq, dh)
    in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k,
                                     group=group, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_call: unsupported device "
                         f"{q.device}")
    kv_len = k.shape[1] if kv_len is None else kv_len
    _check(q, k, v, block_q, block_k, group, kv_len)
    build.check_device(q.device)
    bh, sq, dh = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out  # nothing to launch, nothing to count
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   bh, sq, k.shape[1], dh, group, kv_len, int(causal),
                   int(window), block_q, block_k, _DTYPES[q.dtype],
                   torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {err}")
    flash_attention_call.launches += 1
    return out


flash_attention_call.launches = 0

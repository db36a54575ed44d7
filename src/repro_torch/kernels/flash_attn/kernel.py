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
launches of both.  The kernels' outputs carry no gradient, so a CUDA call
under grad with an input that requires one raises: training goes through
``ops.flash_attention``, whose autograd Function pairs the bf16 kernel,
with its per-row log-sum-exp (``return_lse``), and B6-bwd.

:func:`flash_attention_bwd_call` is B6-bwd (``csrc/flash_attn_bwd.cu``,
bf16 only: a dQ kernel and a dK/dV kernel on wgmma with TMA-fed tiles, no
atomics): dq, dk and dv from q, k, v, out, dout and that log-sum-exp, in
the same layout, at the lengths the forward's tiles give; its plain version
(``ref.flash_attention_bwd_plain``) runs on CPU tensors.
``flash_attention_bwd_call.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import refuse_dtensor, refuse_grad
from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_plain, \
    flash_attention_plain

MAX_BLOCK = 64      # the float32 kernel's largest q and kv tile (rows)
MAX_HEAD_DIM = 128
BF16_HEAD_DIMS = (16, 32, 64, 128)   # the bf16 kernel's template instances
_GRID_Y_MAX = 65535  # CUDA's limit on gridDim.y (the float32 kernel's heads)
_INT_MAX = 2 ** 31 - 1
_TENSOR_MAP_ERRORS = 10000  # sm90_wgmma.cuh: kNoEntryPoint, kEncodeFailed
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
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
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
                         kv_len: int | None = None, scores=None,
                         return_lse: bool = False):
    """q: (BH, Sq, dh); k/v: (BH // group, Sk, dh), f32 or bf16, seqs padded
    to block multiples; blocks default to :func:`default_blocks`;
    ``kv_len`` = true kv length.  Returns (BH, Sq, dh) in q's dtype, and
    with ``return_lse`` (bf16 on the card) also each row's log-sum-exp,
    (BH, Sq) float32 (``ref.flash_attention_plain``), which B6-bwd reads;
    the output is the same bits with or without it.

    ``scores``, for checks only (bf16 on the card): a contiguous float32
    (BH, Sq, Sk) tensor that receives the kernel's scaled scores of every kv
    tile it runs (``ref.flash_attention_plain(scores=...)`` takes them)."""
    refuse_dtensor("flash_attention_call", q, k, v)
    dq, dk = default_blocks(q.dtype, q.shape[-1])
    block_q = dq if block_q is None else block_q
    block_k = dk if block_k is None else block_k
    if q.device.type == "cpu":
        if scores is not None:
            raise ValueError("scores: the kernel's, on the card only")
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k,
                                     group=group, kv_len=kv_len,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_call: unsupported device "
                         f"{q.device}")
    refuse_grad("flash_attention_call", q, k, v)
    if return_lse and q.dtype != torch.bfloat16:
        raise ValueError("return_lse: the bf16 kernel's; the float32 kernel "
                         "writes no log-sum-exp (and has no backward)")
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
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out  # nothing to launch or count
    args = (bh, sq, k.shape[1], dh, group, kv_len, int(causal), int(window))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        err = _entry(True)(*ptrs, None if scores is None
                           else scores.data_ptr(),
                           None if lse is None else lse.data_ptr(), *args,
                           stream)
    else:
        err = _entry(False)(*ptrs, *args, block_q, block_k, stream)
    if err >= _TENSOR_MAP_ERRORS:
        raise RuntimeError(f"flash_attn_sm90: no TMA tensor map (code {err}: "
                           f"10000 no driver entry point, 20000 + CUresult "
                           f"refused)")
    if err:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {err}")
    flash_attention_call.launches += 1
    return (out, lse) if return_lse else out


flash_attention_call.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.load("flash_attn_bwd").flash_attn_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_bwd(q, k, v, out, dout, lse, group, kv_len):
    for name, t in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd_call: dtype {q.dtype} (the "
                         f"kernel is bf16 only)")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"3-d tensor")
    bh, sq, dh = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    if k.shape[2] != dh or v.shape != k.shape or bh != bkv * group \
            or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"group {group}")
    if lse.device != q.device or lse.dtype != torch.float32 \
            or lse.shape != (bh, sq) or not lse.is_contiguous():
        raise ValueError("lse: a contiguous float32 (BH, Sq) tensor on q's "
                         "device")
    if dh not in BF16_HEAD_DIMS:
        raise ValueError(f"head dim {dh}: B6-bwd takes {BF16_HEAD_DIMS}")
    block_q, block_k = bf16_tiles(dh)
    if sq % block_q or sk % block_k:
        raise ValueError(f"Sq {sq}, Sk {sk}: B6-bwd needs Sq a multiple of "
                         f"{block_q} and Sk of {block_k} (the forward's tiles "
                         f"at dh {dh})")
    if bh * sq > _INT_MAX or bkv * sk > _INT_MAX:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: rows "
                         f"beyond the tensor maps' 32-bit coordinates")
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} outside [0, {sk}]")


def flash_attention_bwd_call(q, k, v, out, dout, lse, *, causal: bool = True,
                             window: int = 0, group: int = 1,
                             kv_len: int | None = None):
    """B6-bwd: (dq, dk, dv) of the forward ``out = flash_attention_call(q,
    k, v, ...)`` for the upstream gradient ``dout``, in the forward's padded
    kernel layout — q, out, dout, dq (BH, Sq, dh), k, v, dk, dv (BH // group,
    Sk, dh) — from its ``lse`` (BH, Sq) float32 (``return_lse``), with the
    forward's masks.  A CPU tensor runs ``ref.flash_attention_bwd_plain``;
    a CUDA tensor the bf16 kernel (the lengths that ``ops.kernel_layout``
    gives bf16: Sq a multiple of 128, Sk of ``bf16_tiles(dh)[1]``) or
    raises."""
    refuse_dtensor("flash_attention_bwd_call", q, k, v, out, dout, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                         causal=causal, window=window,
                                         group=group, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_call: unsupported device "
                         f"{q.device}")
    kv_len = k.shape[1] if kv_len is None else kv_len
    _check_bwd(q, k, v, out, dout, lse, group, kv_len)
    build.check_device(q.device)
    bh, sq, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()  # nothing to launch or count
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    err = _bwd_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, sq, k.shape[1], dh, group, kv_len,
        int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err >= _TENSOR_MAP_ERRORS:
        raise RuntimeError(f"flash_attn_bwd: no TMA tensor map (code {err}: "
                           f"10000 no driver entry point, 20000 + CUresult "
                           f"refused)")
    if err:
        raise RuntimeError(f"flash_attn_bwd kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_bwd_call.launches += 1
    return dq, dk, dv


flash_attention_bwd_call.launches = 0

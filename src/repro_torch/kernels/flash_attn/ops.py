"""Public wrapper of B6 (counterpart of ``repro.kernels.flash_attn.ops``):
the (B, S, H, dh) GQA layout -> the kernel's (B*H, S, dh) layout, with the
sequences padded to block multiples and the head grouping passed on."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn.kernel import default_blocks, \
    flash_attention_call


def kernel_layout(q, k, v, *, causal: bool = True, window: int = 0,
                  block_q: int | None = None, block_k: int | None = None):
    """(qf, kf, vf, kwargs): the inputs of :func:`flash_attention_call` for
    (B, S, H, dh) q, k, v — blocks defaulting to the kernel's
    (``kernel.default_blocks``), sequences padded to block multiples,
    ``kv_len`` the true kv length, ``group`` the query heads per kv head (kv
    heads are shared by the kernel's indexing, never copied).  bf16 keeps
    its blocks whatever the length (a prompt shorter than a tile is padded
    to one and masked by ``kv_len``); float32 clamps them to the sequences,
    as the reference does."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dq, dk = default_blocks(q.dtype, dh)
    block_q = dq if block_q is None else block_q
    block_k = dk if block_k is None else block_k
    if q.dtype != torch.bfloat16:
        block_q = min(block_q, max(sq, 8))
        block_k = min(block_k, max(sk, 8))
    pq = (-sq) % block_q
    pk = (-sk) % block_k

    def heads_first(x, pad):
        n, s, h, d = x.shape
        return F.pad(x, (0, 0, 0, 0, 0, pad)).transpose(1, 2).reshape(
            n * h, s + pad, d).contiguous()

    kw = dict(causal=causal, window=window, block_q=block_q,
              block_k=block_k, group=hq // hkv, kv_len=sk)
    return heads_first(q, pq), heads_first(k, pk), heads_first(v, pk), kw


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int | None = None, block_k: int | None = None):
    """q: (B, Sq, Hq, dh); k/v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh).

    On CPU tensors the kernel's plain version runs; on CUDA tensors the
    kernel or an exception.  The blocks default to the kernel's tiles on
    either device: for bf16 the Hopper kernel's q tiles of 128 rows and kv
    tiles of 128 rows (64 at dh 128), the only tiles it takes; for float32
    64 x 64, clamped to the sequences (the scalar kernel takes at most 64)."""
    b, sq, hq, dh = q.shape
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window,
                                   block_q=block_q, block_k=block_k)
    out = flash_attention_call(qf, kf, vf, **kw)
    return out.reshape(b, hq, -1, dh).transpose(1, 2)[:, :sq]

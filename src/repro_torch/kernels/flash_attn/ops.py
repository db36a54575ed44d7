"""Public wrapper of B6 (counterpart of ``repro.kernels.flash_attn.ops``):
the (B, S, H, dh) GQA layout -> the kernel's (B*H, S, dh) layout, with the
sequences padded to block multiples and the head grouping passed on."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.flash_attn.kernel import flash_attention_call


def kernel_layout(q, k, v, *, causal: bool = True, window: int = 0,
                  block_q: int = 64, block_k: int = 64):
    """(qf, kf, vf, kwargs): the inputs of :func:`flash_attention_call` for
    (B, S, H, dh) q, k, v — blocks clamped to the sequences, sequences
    padded to block multiples, ``kv_len`` the true kv length, ``group`` the
    query heads per kv head (kv heads are shared by the kernel's indexing,
    never copied)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
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
                    block_q: int = 64, block_k: int = 64):
    """q: (B, Sq, Hq, dh); k/v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh).

    On CPU tensors the kernel's plain version runs; on CUDA tensors the
    kernel (blocks of at most 64 rows) or an exception."""
    b, sq, hq, dh = q.shape
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window,
                                   block_q=block_q, block_k=block_k)
    out = flash_attention_call(qf, kf, vf, **kw)
    return out.reshape(b, hq, -1, dh).transpose(1, 2)[:, :sq]

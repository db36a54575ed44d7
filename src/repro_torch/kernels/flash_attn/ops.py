"""Public wrapper of B6 (counterpart of ``repro.kernels.flash_attn.ops``):
the (B, S, H, dh) GQA layout -> the kernel's (B*H, S, dh) layout, with the
sequences padded to block multiples and the head grouping passed on.

Under grad, with an input that requires it, :func:`flash_attention` runs
:class:`FlashAttention`, an autograd Function: forward B6 with its per-row
log-sum-exp, backward B6-bwd (``kernel.flash_attention_bwd_call``), both
in the kernel layout; autograd undoes the padding and the head layout
(``kernel_layout``) in both directions.  On CPU tensors the same Function
runs the two plain versions, so the CPU runs the path the card runs.  On
a CUDA tensor it is the bf16 kernels or an exception: the float32 kernel
has no backward and refuses a gradient.  Without grad (serving) the call
is B6 alone, as it was: no log-sum-exp, one launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn.kernel import default_blocks, \
    flash_attention_bwd_call, flash_attention_call


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


class FlashAttention(torch.autograd.Function):
    """B6 with its gradient, on kernel-layout inputs (``kernel_layout``):
    forward ``flash_attention_call(return_lse=True)``, saving q, k, v, out
    and the log-sum-exp; backward ``flash_attention_bwd_call`` on the
    upstream gradient made contiguous (autograd hands back the padded rows'
    zeros)."""

    @staticmethod
    def forward(ctx, qf, kf, vf, kw):
        out, lse = flash_attention_call(qf, kf, vf, **kw, return_lse=True)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, out, lse = ctx.saved_tensors
        kw = ctx.kw
        dq, dk, dv = flash_attention_bwd_call(
            qf, kf, vf, out, dout.contiguous(), lse, causal=kw["causal"],
            window=kw["window"], group=kw["group"], kv_len=kw["kv_len"])
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int | None = None, block_k: int | None = None):
    """q: (B, Sq, Hq, dh); k/v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh).

    On CPU tensors the kernel's plain version runs; on CUDA tensors the
    kernel or an exception.  The blocks default to the kernel's tiles on
    either device: for bf16 the Hopper kernel's q tiles of 128 rows and kv
    tiles of 128 rows (64 at dh 128), the only tiles it takes; for float32
    64 x 64, clamped to the sequences (the scalar kernel takes at most 64).
    Under grad with an input that requires it, :class:`FlashAttention`
    (B6 and B6-bwd; on a CUDA float32 input the float32 kernel raises)."""
    b, sq, hq, dh = q.shape
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window,
                                   block_q=block_q, block_k=block_k)
    wants_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if wants_grad and (q.device.type == "cpu" or q.dtype == torch.bfloat16):
        out = FlashAttention.apply(qf, kf, vf, kw)
    else:  # serving; or CUDA float32 under grad, which the kernel refuses
        out = flash_attention_call(qf, kf, vf, **kw)
    return out.reshape(b, hq, -1, dh).transpose(1, 2)[:, :sq]

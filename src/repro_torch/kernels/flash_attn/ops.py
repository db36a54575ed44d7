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

The model reaches both kernels through two operators, ``repro_torch::
flash_attn`` and ``repro_torch::flash_attn_bwd`` (``torch.library.
custom_op``), so that a dispatch mode sees each launch as one op: their
implementations call the wrappers (the kernel on CUDA tensors, the plain
version on CPU tensors; bits and launch counts are the wrappers'), their
fake implementations give shapes only and are reached only under
``FakeTensorMode`` (the dry-run), and their FLOP formulas
(``torch.utils.flop_counter.register_flop_formula``) are the bounds' of
``PERF.md``: 4 x BH x dh a kept (query, key) pair for B6, 10 for B6-bwd
(:func:`kept_pairs`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.common import refuse_grad
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


def kept_pairs(sq: int, kv_len: int, causal: bool, window: int) -> int:
    """The (query, key) pairs that B6's masks keep for one head: query rows
    ``0..sq-1`` (the padded rows too: the kernel runs them), keys below
    ``kv_len``, ``key <= query`` when causal, ``key > query - window``
    with a window.  Summed in closed form between the points where a
    row's count changes slope."""
    def count(q):
        hi = min(kv_len - 1, q) if causal else kv_len - 1
        lo = max(0, q - window + 1) if window else 0
        return max(0, hi - lo + 1)

    cuts = sorted({0, sq, *(c for c in (kv_len, kv_len - 1, window,
                                        window - 1, kv_len + window - 1,
                                        kv_len + window - 2) if 0 < c < sq)})
    total = 0
    for a, b in zip(cuts, cuts[1:]):  # count is linear on [a, b)
        total += (count(a) + count(b - 1)) * (b - a) // 2
    return total


@torch.library.custom_op("repro_torch::flash_attn", mutates_args=())
def flash_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int, block_q: int, block_k: int,
                  group: int, kv_len: int, return_lse: bool
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """B6 on kernel-layout inputs: (out, lse), lse empty without
    ``return_lse``."""
    kw = dict(causal=causal, window=window, block_q=block_q,
              block_k=block_k, group=group, kv_len=kv_len)
    if return_lse:
        return flash_attention_call(q, k, v, **kw, return_lse=True)
    out = flash_attention_call(q, k, v, **kw)
    return out, out.new_empty((0,), dtype=torch.float32)


@flash_attn_op.register_fake
def _(q, k, v, causal, window, block_q, block_k, group, kv_len, return_lse):
    lse = (q.shape[0], q.shape[1]) if return_lse else (0,)
    return torch.empty_like(q), q.new_empty(lse, dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attn_bwd", mutates_args=())
def flash_attn_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor,
                      lse: torch.Tensor, causal: bool, window: int,
                      group: int, kv_len: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B6-bwd on kernel-layout inputs: (dq, dk, dv)."""
    return flash_attention_bwd_call(q, k, v, out, dout, lse, causal=causal,
                                    window=window, group=group,
                                    kv_len=kv_len)


@flash_attn_bwd_op.register_fake
def _(q, k, v, out, dout, lse, causal, window, group, kv_len):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attn, get_raw=True)
def _flash_attn_flops(q, k, v, causal, window, block_q, block_k, group,
                      kv_len, return_lse, *args, **kwargs) -> int:
    bh, sq, dh = q.shape
    return 4 * bh * dh * kept_pairs(sq, kv_len, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attn_bwd, get_raw=True)
def _flash_attn_bwd_flops(q, k, v, out, dout, lse, causal, window, group,
                          kv_len, *args, **kwargs) -> int:
    bh, sq, dh = q.shape
    return 10 * bh * dh * kept_pairs(sq, kv_len, causal, window)


class FlashAttention(torch.autograd.Function):
    """B6 with its gradient, on kernel-layout inputs (``kernel_layout``):
    forward ``flash_attention_call(return_lse=True)``, saving q, k, v, out
    and the log-sum-exp; backward ``flash_attention_bwd_call`` on the
    upstream gradient made contiguous (autograd hands back the padded rows'
    zeros)."""

    @staticmethod
    def forward(ctx, qf, kf, vf, kw):
        out, lse = flash_attn_op(qf, kf, vf, **kw, return_lse=True)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, out, lse = ctx.saved_tensors
        kw = ctx.kw
        dq, dk, dv = flash_attn_bwd_op(
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
        if wants_grad:  # here: below autograd no input requires grad
            refuse_grad("flash_attention_call", qf, kf, vf)
        out = flash_attn_op(qf, kf, vf, **kw, return_lse=False)[0]
    return out.reshape(b, hq, -1, dh).transpose(1, 2)[:, :sq]

"""GQA attention (counterpart of ``repro.models.attention``): the prefill
path on the flash-attention kernel B6, and single-token decode against a
KV cache.

Prefill: :func:`attention` computes what the reference's chunked full
softmax computes — causal, sliding-window or unmasked GQA attention — on
B6 (``kernels/flash_attn``): the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor.  The reference's banded sliding-window path is not
needed: B6 skips the kv blocks outside the band.  Cross-attention (the
encoder-decoder family, ``attn_block(kv_source=...)``) is B6 unmasked over
the encoder's length, q and k without RoPE.

Decode: :func:`decode_attention` is plain PyTorch, as the reference's is
XLA einsum and softmax (no Pallas kernel).  The cache is a ring buffer:
token ``index`` goes to slot ``index mod capacity`` (:func:`write_cache_slot`),
written in place — the reference returns a new cache array; the port saves
the copy.  A cache made by prefill is exactly as long as the prompt, so
every decoded token overwrites the oldest prompt slot and decode attends
over all ``capacity`` slots; RoPE positions stay absolute.  That is the
reference's behaviour and the port keeps it (ROADMAP.md §C).

Sharding (``repro_torch.dist``): :func:`attn_axes` names each weight's
logical axes, heads on ``"tp"``.  Under a mesh q, k and v are placed
``("batch", None, "tp", None)`` and B6 runs in ``local_map`` on each
rank's own batch rows and heads (:func:`attention`): heads are
independent, and ``padded_heads(tp)`` keeps each rank's query heads a
whole number of its kv heads' groups.  Cross-attention places k and v,
projected from the encoder's states at their own length, as q: rows and
heads, never the sequence, so Sq != Sk needs nothing more per rank.  No DTensor reaches the kernel
wrapper.  Padded query heads (``init_attn(true_hq=)``) have zero ``wq``
columns and ``wo`` rows, so they add nothing, as in the reference.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist.sharding import (axes_to_placements, current_rules,
                                       replicated_like, shard)
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models.common import apply_rope, dense, normal_init

NEG_INF = -1e30


class AttentionParams(NamedTuple):
    wq: torch.Tensor            # (d, Hq*dh)
    wk: torch.Tensor            # (d, Hkv*dh)
    wv: torch.Tensor            # (d, Hkv*dh)
    wo: torch.Tensor            # (Hq*dh, d)
    bq: torch.Tensor | None
    bk: torch.Tensor | None
    bv: torch.Tensor | None


def init_attn(generator, d_model, hq, hkv, dh, qkv_bias=False,
              device=None, true_hq=None) -> AttentionParams:
    """``true_hq``: the unpadded query heads; the padded ones (``hq`` past
    it, ``padded_heads(tp)``) get zero ``wq`` columns and ``wo`` rows."""
    def normal(shape, scale=0.02):
        return normal_init(generator, shape, scale, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device) \
            if qkv_bias else None

    wq = normal((d_model, hq * dh))
    wk, wv = normal((d_model, hkv * dh)), normal((d_model, hkv * dh))
    wo = normal((hq * dh, d_model), 0.02 / math.sqrt(2))
    if true_hq is not None and true_hq < hq:
        wq[:, true_hq * dh:] = 0.0
        wo[true_hq * dh:, :] = 0.0
    return AttentionParams(wq=wq, wk=wk, wv=wv, wo=wo, bq=zeros(hq * dh),
                           bk=zeros(hkv * dh), bv=zeros(hkv * dh))


def attn_axes(qkv_bias=False) -> AttentionParams:
    """One layer's logical axes (the reference's ``attn_axes`` without its
    leading stacked-layer ``None``)."""
    return AttentionParams(
        wq=("fsdp", "tp"), wk=("fsdp", "tp"), wv=("fsdp", "tp"),
        wo=("tp", "fsdp"),
        bq=("tp",) if qkv_bias else None,
        bk=("tp",) if qkv_bias else None,
        bv=("tp",) if qkv_bias else None)


#: the logical axes of (B, S, H, dh) q, k, v and attention's output
QKV_AXES = ("batch", None, "tp", None)


def attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh), Hq a
    multiple of Hkv.  Runs B6: on CUDA tensors the kernel or an exception,
    on CPU tensors its plain version.  DTensors run B6 in ``local_map`` on
    each rank's local shard (:func:`local_placements`), under grad B6 and
    B6-bwd (``ops.FlashAttention``) the same way."""
    fn = partial(flash_attention, causal=causal, window=window or 0)
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map
    pl = list(local_placements(q))  # a list: one output's placements
    return local_map(fn, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def local_placements(q) -> tuple:
    """Where attention runs per rank for a DTensor q (B, S, H, dh): the
    ambient rules' ``QKV_AXES`` on q's mesh, else q's own placements with
    all but batch rows (``Shard(0)``) and heads (``Shard(2)``) gathered.
    Never the sequence or a pending sum: each rank needs whole rows of
    scores."""
    rules = current_rules()
    if rules is not None and rules.mesh is q.device_mesh:
        return axes_to_placements(QKV_AXES, rules)
    return tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                 else Replicate() for p in q.placements)


def attn_block(p: AttentionParams, x, *, cfg_heads, rope_theta, causal=True,
               window=None, positions=None, quant="none", return_kv=False,
               kv_source=None):
    """x: (B, S, d); cfg_heads = (hq, hkv, dh).  ``kv_source`` (B, Sk, d):
    the encoder states K and V are projected from, for cross-attention
    (default x); neither side is rotated then."""
    hq, hkv, dh = cfg_heads
    b, s, _ = x.shape
    src = x if kv_source is None else kv_source
    sk = src.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = dense(x, p.wq, p.bq, quant=quant).reshape(b, s, hq, dh)
    k = dense(src, p.wk, p.bk, quant=quant).reshape(b, sk, hkv, dh)
    v = dense(src, p.wv, p.bv, quant=quant).reshape(b, sk, hkv, dh)
    if kv_source is None and rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, torch.arange(sk, device=x.device)[None, :],
                       rope_theta)
    q, k, v = (shard(t, *QKV_AXES) for t in (q, k, v))
    out = shard(attention(q, k, v, causal=causal, window=window), *QKV_AXES)
    y = dense(out.reshape(b, s, hq * dh), p.wo, quant=quant)
    if return_kv:
        return y, (k, v)
    return y


def decode_attention(q1, k_cache, v_cache, cache_len: int, *,
                     window: int = 0):
    """q1: (B, Hq, dh); caches (B, S, Hkv, dh).  Returns (B, Hq, dh): f32
    scores of the inputs' products, slots at or past ``cache_len`` (and
    before ``cache_len - window``) masked, softmax, p in the cache's dtype,
    f32 P V."""
    b, hq, dh = q1.shape
    sk, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q1.reshape(b, hkv, g, dh).to(k_cache.dtype)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    pos = torch.arange(sk, device=q1.device)
    keep = pos < cache_len
    if window:
        keep = keep & (pos >= cache_len - window)
    s = torch.where(replicated_like(keep, s), s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p.float(), v_cache.float())
    return out.reshape(b, hq, dh).to(q1.dtype)


def write_cache_slot(cache, new, index: int) -> None:
    """Write one token's K or V (B, Hkv, dh) into a (B, S, Hkv, dh) cache at
    slot ``index mod S`` (a ring buffer), in place (a DTensor ``new``
    placed as the cache's slot first)."""
    slot = cache[:, index % cache.shape[1]]
    if isinstance(new, DTensor) and isinstance(slot, DTensor):
        new = new.redistribute(slot.device_mesh, slot.placements)
    slot.copy_(new.to(cache.dtype))


def decode_attn_block(p: AttentionParams, x1, cache_k, cache_v,
                      cache_len: int, *, cfg_heads, rope_theta, window=0,
                      quant="none", cross_kv=None):
    """x1: (B, d) single-token residual at position ``cache_len``; caches
    (B, S, Hkv, dh), written in place at slot ``cache_len mod S``.  Returns
    (y1, cache_k, cache_v).  ``cross_kv``: the (k, v) of the encoder
    states, (B, Se, Hkv, dh) each: cross-attention over all Se of them, q
    not rotated, the caches returned untouched."""
    hq, hkv, dh = cfg_heads
    b, _ = x1.shape
    q = dense(x1, p.wq, p.bq, quant=quant).reshape(b, hq, dh)
    if cross_kv is not None:
        k_cross, v_cross = cross_kv
        out = decode_attention(q, k_cross, v_cross, k_cross.shape[1])
        y = dense(out.reshape(b, hq * dh), p.wo, quant=quant)
        return y, cache_k, cache_v
    k = dense(x1, p.wk, p.bk, quant=quant).reshape(b, hkv, dh)
    v = dense(x1, p.wv, p.bv, quant=quant).reshape(b, hkv, dh)
    if rope_theta:
        # the position made on the device: no host-to-device copy
        pos = torch.arange(cache_len, cache_len + 1, device=x1.device)[None]
        q = apply_rope(q[:, None], pos, rope_theta)[:, 0]
        k = apply_rope(k[:, None], pos, rope_theta)[:, 0]
    write_cache_slot(cache_k, k, cache_len)
    write_cache_slot(cache_v, v, cache_len)
    cache_k = shard(cache_k, "batch", "cache_seq", None, None)
    cache_v = shard(cache_v, "batch", "cache_seq", None, None)
    out = decode_attention(q, cache_k, cache_v, cache_len + 1, window=window)
    y = dense(out.reshape(b, hq * dh), p.wo, quant=quant)
    return y, cache_k, cache_v

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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

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
              device=None) -> AttentionParams:
    def normal(shape, scale=0.02):
        return normal_init(generator, shape, scale, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device) \
            if qkv_bias else None

    return AttentionParams(
        wq=normal((d_model, hq * dh)), wk=normal((d_model, hkv * dh)),
        wv=normal((d_model, hkv * dh)),
        wo=normal((hq * dh, d_model), 0.02 / math.sqrt(2)),
        bq=zeros(hq * dh), bk=zeros(hkv * dh), bv=zeros(hkv * dh))


def attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh), Hq a
    multiple of Hkv.  Runs B6: on CUDA tensors the kernel or an exception,
    on CPU tensors its plain version."""
    return flash_attention(q, k, v, causal=causal, window=window or 0)


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
    out = attention(q, k, v, causal=causal, window=window)
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
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p.float(), v_cache.float())
    return out.reshape(b, hq, dh).to(q1.dtype)


def write_cache_slot(cache, new, index: int) -> None:
    """Write one token's K or V (B, Hkv, dh) into a (B, S, Hkv, dh) cache at
    slot ``index mod S`` (a ring buffer), in place."""
    cache[:, index % cache.shape[1]] = new.to(cache.dtype)


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
    out = decode_attention(q, cache_k, cache_v, cache_len + 1, window=window)
    y = dense(out.reshape(b, hq * dh), p.wo, quant=quant)
    return y, cache_k, cache_v

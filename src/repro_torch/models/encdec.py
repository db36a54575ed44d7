"""Encoder-decoder backbone (counterpart of ``repro.models.encdec``, the
seamless-m4t family): a bidirectional encoder over precomputed frame
embeddings (the speech frontend is a stub, as in the reference), a causal
decoder with cross-attention to the encoder's output, prefill (the encoder
pass, each decoder layer's cross K/V built once, the last token's logits)
and single-token decode against the self-attention cache and the static
cross cache.

Every prefill attention runs on B6 (``models.attention``): the encoder's
unmasked self-attention with RoPE, the decoder's causal self-attention with
RoPE, and its cross-attention, unmasked over the encoder's
:func:`enc_len_for` frames with neither side rotated.  Decode attention is
plain PyTorch, as the reference's is XLA.

Params: ``{"enc": {"layers": [{"ln1", "attn", "ln2", "mlp"}, ...], "norm"},
"dec": {"embed", "layers": [{"ln1", "attn", "ln_cross", "cross", "ln2",
"mlp"}, ...], "norm"}, "head"}``, fp32 masters or their bf16 copy, the
reference's ``(in, out)`` layout, one dict per layer
(``convert.lm_params_from_numpy`` carries the reference's stacked params
across).  Cache, bf16: ``{"k", "v"}`` (L, B, S, Hkv, dh), the decoder's
self-attention, as long as the prompt, decode's token t written at slot
``t mod S`` (the reference's ring, ROADMAP.md §C); ``{"cross_k",
"cross_v"}`` (L, B, Se, Hkv, dh), the encoder's K/V, never written after
prefill.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import shard
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (COMPUTE, embed_lookup, normal_init,
                                      rms_norm)
from repro_torch.models.lm import (ModelFns, _heads, _logits, _residual,
                                  cross_entropy)
from repro_torch.models.mlp import init_mlp, mlp_axes, mlp_block
from repro_torch.tree import tree_map

TOKENS_PER_FRAME = 4  # the encoder sees a quarter as many frames as tokens


def enc_len_for(seq_len: int) -> int:
    """Encoder frames beside a decoder prompt of ``seq_len`` tokens: a
    quarter of them, at least 8 (the reference's convention)."""
    return max(seq_len // TOKENS_PER_FRAME, 8)


def _layer_init(cfg: ModelConfig, generator, tp: int, device, *,
                cross: bool) -> dict:
    d = cfg.d_model
    hq, hkv, dh = _heads(cfg, tp)
    ones = partial(torch.ones, (d,), dtype=torch.float32, device=device)

    def attention():
        return attn.init_attn(generator, d, hq, hkv, dh, cfg.qkv_bias,
                              device=device, true_hq=cfg.n_heads)

    layer = {"ln1": ones(), "attn": attention()}
    if cross:
        layer.update(ln_cross=ones(), cross=attention())
    layer.update(ln2=ones(), mlp=init_mlp(generator, d, cfg.d_ff,
                                          cfg.gated_mlp, device=device))
    return layer


def encdec_axes(cfg: ModelConfig) -> dict:
    """The params' logical axes, one entry per layer (the reference's
    ``encdec_param_axes``, whose name its dead-exports allowlist holds)."""
    def layer(cross: bool) -> dict:
        out = {"ln1": (None,), "attn": attn.attn_axes(cfg.qkv_bias),
               "ln2": (None,), "mlp": mlp_axes(cfg.gated_mlp)}
        if cross:
            out.update(ln_cross=(None,), cross=attn.attn_axes(cfg.qkv_bias))
        return out

    return {"enc": {"layers": [layer(False) for _ in range(cfg.n_enc_layers)],
                    "norm": (None,)},
            "dec": {"embed": ("tp", "fsdp"),
                    "layers": [layer(True) for _ in range(cfg.n_layers)],
                    "norm": (None,)},
            "head": ("fsdp", "tp")}


def encdec_cache_axes(cfg: ModelConfig) -> dict:
    """The caches' logical axes (stacked, as ``init_cache`` makes them)."""
    ax = (None, "batch", "cache_seq", None, None)
    return {"k": ax, "v": ax, "cross_k": ax, "cross_v": ax}


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                tp: int = 1, dtype=torch.float32) -> dict:
    """Params from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (raises for CUDA without a card): fp32 masters, or with ``dtype`` their
    values cast to it layer by layer as they are drawn (``lm.init_params``
    says why)."""
    dev = resolve_device(device, meta=True)
    gen = (None if dev.type == "meta"  # shapes only: nothing to draw
           else torch.Generator(device=dev).manual_seed(seed))
    d, vp = cfg.d_model, cfg.padded_vocab(tp)

    def cast(tree):
        return tree_map(lambda t: t.to(dtype), tree)

    def stack(n, cross):
        return [cast(_layer_init(cfg, gen, tp, dev, cross=cross))
                for _ in range(n)]

    def norm():
        return torch.ones((d,), dtype=dtype, device=dev)

    enc = stack(cfg.n_enc_layers, False)
    dec = stack(cfg.n_layers, True)
    return {"enc": {"layers": enc, "norm": norm()},
            "dec": {"embed": cast(normal_init(gen, (vp, d), device=dev)),
                    "layers": dec, "norm": norm()},
            "head": cast(normal_init(gen, (d, vp), device=dev))}


def _enc_block(cfg: ModelConfig, tp: int, h, lp):
    """One encoder layer over h (B, Se, d): unmasked self-attention with
    RoPE, then the MLP."""
    x = rms_norm(h, lp["ln1"], cfg.norm_eps)
    h = h + _residual(attn.attn_block(lp["attn"], x,
                                      cfg_heads=_heads(cfg, tp),
                                      rope_theta=cfg.rope_theta,
                                      causal=False, quant=cfg.quant))
    return h + mlp_block(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                         quant=cfg.quant)


def _remat(cfg: ModelConfig) -> bool:
    """Checkpoint each block (encoder and decoder) under grad, as the
    reference's ``jax.checkpoint`` of both scanned bodies: its activations
    are recomputed in the backward, whatever ``cfg.remat`` says (the
    reference's encoder-decoder reads neither it nor ``parallel_block``)."""
    return torch.is_grad_enabled()


def encode(cfg: ModelConfig, tp: int, params, frames):
    """The encoder over the frames (B, Se, d), cast to bf16, ending in its
    RMSNorm: the states every decoder layer's cross K/V are projected
    from."""
    h = shard(frames.to(COMPUTE), "batch", "act_seq", None)
    remat = _remat(cfg)
    for lp in params["enc"]["layers"]:
        block = partial(_enc_block, cfg, tp, lp=lp)
        h = checkpoint(block, h, use_reentrant=False) if remat else block(h)
        h = shard(h, "batch", "act_seq", None)
    return rms_norm(h, params["enc"]["norm"], cfg.norm_eps)


def _dec_block(cfg: ModelConfig, tp: int, h, lp, enc_out, *,
               return_kv: bool):
    """One decoder layer over h (B, S, d): causal self-attention, then
    cross-attention to ``enc_out`` (B, Se, d), then the MLP.  Returns (h,
    ((k, v), (cross_k, cross_v)) with ``return_kv``, else None)."""
    heads = _heads(cfg, tp)
    x = rms_norm(h, lp["ln1"], cfg.norm_eps)
    a = attn.attn_block(lp["attn"], x, cfg_heads=heads,
                        rope_theta=cfg.rope_theta, causal=True,
                        quant=cfg.quant, return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    h = h + _residual(a)
    xc = rms_norm(h, lp["ln_cross"], cfg.norm_eps)
    c = attn.attn_block(lp["cross"], xc, cfg_heads=heads,
                        rope_theta=cfg.rope_theta, causal=False,
                        quant=cfg.quant, return_kv=return_kv,
                        kv_source=enc_out)
    c, ckv = c if return_kv else (c, None)
    h = h + _residual(c)
    h = h + mlp_block(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                      quant=cfg.quant)
    return h, ((kv, ckv) if return_kv else None)


def _dec_layer(cfg: ModelConfig, tp: int, lp, h, enc_out):
    """:func:`_dec_block` without the caches, its layer bound first."""
    return _dec_block(cfg, tp, h, lp, enc_out, return_kv=False)[0]


def _embed(params, tokens, axes=("batch", "act_seq", None)):
    return shard(embed_lookup(params["dec"]["embed"], tokens).to(COMPUTE),
                 *axes)


def prefill(cfg: ModelConfig, tp: int, params, batch):
    """The encoder over ``batch["frames"]`` (B, Se, d), then the decoder over
    the prompt ``batch["tokens"]`` (B, S); returns (cache, last-token
    logits (B, V))."""
    enc_out = encode(cfg, tp, params, batch["frames"])
    h = _embed(params, batch["tokens"])
    kvs = []
    for lp in params["dec"]["layers"]:
        h, kv = _dec_block(cfg, tp, h, lp, enc_out, return_kv=True)
        h = shard(h, "batch", "act_seq", None)
        kvs.append(kv)
    cache = {name: shard(torch.stack([kv[side][j] for kv in kvs])
                         .to(COMPUTE), "layers", "batch", "cache_seq", None,
                         None)
             for name, side, j in (("k", 0, 0), ("v", 0, 1),
                                   ("cross_k", 1, 0), ("cross_v", 1, 1))}
    h = rms_norm(h[:, -1, :], params["dec"]["norm"], cfg.norm_eps)
    return cache, _logits(params, h)


def seq2seq_loss(cfg: ModelConfig, tp: int, params, batch):
    """The training loss on ``batch`` {"frames" (B, Se, d), "tokens",
    "labels" (B, S)}: the encoder over the frames, the decoder over the
    tokens with cross-attention to it, its final norm, the logits and
    ``lm.cross_entropy`` (the reference's ``encdec_loss``, a name its
    dead-exports allowlist holds).  Under grad each encoder and decoder
    block is checkpointed (:func:`_remat`): a step launches B6 twice a
    layer's attention (forward and recompute) and B6-bwd once."""
    enc_out = encode(cfg, tp, params, batch["frames"])
    h = _embed(params, batch["tokens"])
    remat = _remat(cfg)
    for lp in params["dec"]["layers"]:
        block = partial(_dec_layer, cfg, tp, lp)
        h = checkpoint(block, h, enc_out, use_reentrant=False) if remat \
            else block(h, enc_out)
        h = shard(h, "batch", "act_seq", None)
    h = rms_norm(h, params["dec"]["norm"], cfg.norm_eps)
    return cross_entropy(_logits(params, h), batch["labels"], cfg.vocab_size)


def _decode_block(cfg: ModelConfig, tp: int, h1, lp, layer, cache_len: int):
    """One token (B, d) through one decoder layer; ``layer`` is the layer's
    ``{"k", "v", "cross_k", "cross_v"}``, its self-attention K/V written in
    place."""
    heads = _heads(cfg, tp)
    x = rms_norm(h1, lp["ln1"], cfg.norm_eps)
    a, _, _ = attn.decode_attn_block(
        lp["attn"], x, layer["k"], layer["v"], cache_len, cfg_heads=heads,
        rope_theta=cfg.rope_theta, quant=cfg.quant)
    h1 = h1 + _residual(a)
    xc = rms_norm(h1, lp["ln_cross"], cfg.norm_eps)
    c, _, _ = attn.decode_attn_block(
        lp["cross"], xc, layer["k"], layer["v"], cache_len, cfg_heads=heads,
        rope_theta=cfg.rope_theta, quant=cfg.quant,
        cross_kv=(layer["cross_k"], layer["cross_v"]))
    h1 = h1 + _residual(c)
    return h1 + mlp_block(lp["mlp"], rms_norm(h1, lp["ln2"], cfg.norm_eps),
                          quant=cfg.quant)


def decode_token(cfg: ModelConfig, tp: int, params, cache, tokens1,
                 cache_len: int):
    """tokens1: (B,) the newly sampled tokens; ``cache_len`` the position
    they take.  Writes their self-attention K and V into ``cache`` in
    place; returns (logits (B, V), cache)."""
    h = _embed(params, tokens1, axes=("batch", None))
    for i, lp in enumerate(params["dec"]["layers"]):
        layer = {name: t[i] for name, t in cache.items()}
        h = _decode_block(cfg, tp, h, lp, layer, cache_len)
    h = rms_norm(h, params["dec"]["norm"], cfg.norm_eps)
    return _logits(params, h), cache


def init_cache(cfg: ModelConfig, tp: int, batch: int, seq: int, *,
               device="cuda"):
    """Zeroed caches for a prompt of ``seq`` tokens: self-attention K/V of
    ``seq`` slots, cross K/V of ``enc_len_for(seq)``."""
    dev = resolve_device(device, meta=True)
    _, hkv, dh = _heads(cfg, tp)

    def zeros(slots):
        return torch.zeros((cfg.n_layers, batch, slots, hkv, dh),
                           dtype=COMPUTE, device=dev)

    se = enc_len_for(seq)
    return {"k": zeros(seq), "v": zeros(seq), "cross_k": zeros(se),
            "cross_v": zeros(se)}


def build_encdec(cfg: ModelConfig, tp: int = 1) -> ModelFns:
    cfg.validate()
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: family {cfg.family!r}, not encdec")
    return ModelFns(
        cfg=cfg,
        init=partial(init_params, cfg, tp=tp),
        loss=partial(seq2seq_loss, cfg, tp),
        prefill=partial(prefill, cfg, tp),
        decode=partial(decode_token, cfg, tp),
        init_cache=partial(init_cache, cfg, tp),
        param_axes=partial(encdec_axes, cfg))

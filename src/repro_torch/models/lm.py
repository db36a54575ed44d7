"""Decoder-only LM assembly for the dense and MoE families (counterpart of
``repro.models.lm``): init, prefill and single-token decode, and
:class:`ModelFns`, the bundle of model functions every family builds.

The layer stack is a Python loop over per-layer params (the reference
scans over params stacked on a leading L axis).  Params are
``{"embed": (V, d), "layers": [{"ln1", "attn": AttentionParams, "ln2",
"mlp": MlpParams | "moe": MoeParams}, ...], "final_norm": (d,), "head":
(d, V)}`` in fp32, the ``(in, out)`` layout of the reference;
``convert.lm_params_from_numpy`` carries the reference's stacked params
across.  Activations are bf16 from the embedding on.  An MoE layer's FFN is
``models.moe.moe_block`` (attention stays on B6); its load-balance loss
matters only to the LM training still to come and is dropped here.

Caches are bf16: ``{"k", "v"}`` of shape (L, B, S, Hkv, dh) — the stacked
cache — or, with ``cfg.decode_unroll``, a tuple of per-layer ``{"k", "v"}``
of shape (B, S, Hkv, dh).  Decode writes its token's K and V into the
cache in place and returns the same cache object.

LM training (``lm_loss`` / ``cross_entropy`` of the reference) and the
SSM, hybrid, encoder-decoder and VLM families arrive with later slices.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import COMPUTE, normal_init, rms_norm
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ModelFns:
    cfg: ModelConfig
    init: Callable                      # (seed | generator, ...) -> params
    loss: Callable                      # (params, batch) -> scalar
    prefill: Callable | None = None     # (params, batch) -> (cache, logits)
    decode: Callable | None = None      # (params, cache, tokens1, cache_len)
                                        #   -> (logits, cache)
    init_cache: Callable | None = None  # (batch, seq, device=) -> cache
    predict: Callable | None = None     # MRF: (params, batch) -> (B, 2)
    qat_loss: Callable | None = None    # MRF: (params, qstate, batch)
    init_qat_aux: Callable | None = None  # MRF: params -> qstate


def _heads(cfg: ModelConfig, tp: int) -> tuple:
    return (*cfg.padded_heads(tp), cfg.head_dim)


def _layer_init(cfg: ModelConfig, generator, tp: int, device) -> dict:
    d = cfg.d_model
    hq, hkv, dh = _heads(cfg, tp)
    ones = partial(torch.ones, (d,), dtype=torch.float32, device=device)
    layer = {"ln1": ones(),
             "attn": attn.init_attn(generator, d, hq, hkv, dh, cfg.qkv_bias,
                                    device=device),
             "ln2": ones()}
    if cfg.family == "moe":
        layer["moe"] = init_moe(generator, d, cfg.d_ff, cfg.n_experts,
                                cfg.n_shared_experts, cfg.gated_mlp,
                                device=device)
    else:
        layer["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.gated_mlp,
                                device=device)
    return layer


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                tp: int = 1, dtype=torch.float32) -> dict:
    """Params from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (raises for CUDA without a card): fp32 masters, or with ``dtype`` the
    masters' values cast to it (``COMPUTE``, bf16, for serving).  The cast
    is made layer by layer as the params are drawn, so at most one layer's
    fp32 masters are alive at a time: qwen2.5-14b's bf16 params (30 GB) are
    made without its 59 GB of masters.  Every use of a param casts it to the
    bf16 activations first, so serving from the bf16 params gives the same
    values as serving from the masters; the one param used in f32, an MoE
    layer's router, keeps its masters' values."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, vp = cfg.d_model, cfg.padded_vocab(tp)

    def cast(tree):
        return tree_map(lambda t: t.to(dtype), tree)

    def cast_layer(layer):
        out = cast(layer)
        if "moe" in layer:
            out["moe"] = out["moe"]._replace(router=layer["moe"].router)
        return out

    layers = [cast_layer(_layer_init(cfg, gen, tp, dev))
              for _ in range(cfg.n_layers)]
    return {"embed": cast(normal_init(gen, (vp, d), device=dev)),
            "layers": layers,
            "final_norm": torch.ones((d,), dtype=dtype, device=dev),
            "head": cast(normal_init(gen, (d, vp), device=dev))}


def _ffn(cfg: ModelConfig, lp, x):
    """The layer's FFN on x (B, S, d): the dense MLP or the MoE block."""
    if cfg.family == "moe":
        y, _ = moe_block(lp["moe"], x, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor)
        return y
    return mlp_block(lp["mlp"], x, quant=cfg.quant)


def _block(cfg: ModelConfig, tp: int, h, lp, *, return_kv: bool):
    """One pre-norm residual block. h: (B, S, d)."""
    x = rms_norm(h, lp["ln1"], cfg.norm_eps)
    a_out = attn.attn_block(lp["attn"], x, cfg_heads=_heads(cfg, tp),
                            rope_theta=cfg.rope_theta, causal=True,
                            window=cfg.swa_window or None, quant=cfg.quant,
                            return_kv=return_kv)
    kv = None
    if return_kv:
        a_out, kv = a_out
    h = h + a_out
    return h + _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps)), kv


def _embed(params, tokens):
    return params["embed"][tokens].to(COMPUTE)


def _stack_forward(cfg: ModelConfig, tp: int, params, h, *,
                   collect_kv: bool):
    """Runs the layer stack. Returns (h, [(k, v) per layer] or None)."""
    kvs = []
    for lp in params["layers"]:
        h, kv = _block(cfg, tp, h, lp, return_kv=collect_kv)
        kvs.append(kv)
    return h, (kvs if collect_kv else None)


def _logits(params, h):
    return torch.matmul(h, params["head"].to(h.dtype))


def init_cache(cfg: ModelConfig, tp: int, batch: int, seq: int, *,
               device="cuda"):
    """Zeroed bf16 caches: stacked, or per layer with ``decode_unroll``."""
    dev = resolve_device(device)
    _, hkv, dh = _heads(cfg, tp)

    def zeros(*lead):
        return torch.zeros((*lead, batch, seq, hkv, dh), dtype=COMPUTE,
                           device=dev)

    if cfg.decode_unroll:
        return tuple({"k": zeros(), "v": zeros()}
                     for _ in range(cfg.n_layers))
    return {"k": zeros(cfg.n_layers), "v": zeros(cfg.n_layers)}


def prefill(cfg: ModelConfig, tp: int, params, batch):
    """Causal forward over the prompt ``batch["tokens"]`` (B, S); returns
    (cache as long as the prompt, last-token logits (B, V))."""
    h = _embed(params, batch["tokens"])
    h, kvs = _stack_forward(cfg, tp, params, h, collect_kv=True)
    if cfg.decode_unroll:
        cache = tuple({"k": k.to(COMPUTE), "v": v.to(COMPUTE)}
                      for k, v in kvs)
    else:
        cache = {"k": torch.stack([k for k, _ in kvs]).to(COMPUTE),
                 "v": torch.stack([v for _, v in kvs]).to(COMPUTE)}
    h = rms_norm(h[:, -1, :], params["final_norm"], cfg.norm_eps)
    return cache, _logits(params, h)


def _decode_block(cfg: ModelConfig, tp: int, h1, lp, cache_k, cache_v,
                  cache_len):
    x = rms_norm(h1, lp["ln1"], cfg.norm_eps)
    # the reference's dense decode passes no window (lm.py _decode_block)
    a_out, _, _ = attn.decode_attn_block(
        lp["attn"], x, cache_k, cache_v, cache_len, cfg_heads=_heads(cfg, tp),
        rope_theta=cfg.rope_theta, quant=cfg.quant)
    h1 = h1 + a_out
    x2 = rms_norm(h1, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":  # the B tokens route as one group of (B, 1)
        return h1 + _ffn(cfg, lp, x2[:, None, :])[:, 0, :]
    return h1 + _ffn(cfg, lp, x2)


def decode_token(cfg: ModelConfig, tp: int, params, cache, tokens1,
                 cache_len: int):
    """tokens1: (B,) the newly sampled tokens; ``cache_len`` the position
    they take.  Writes their K and V into ``cache`` in place; returns
    (logits (B, V), cache)."""
    h = _embed(params, tokens1)
    for i, lp in enumerate(params["layers"]):
        layer = cache[i] if cfg.decode_unroll else \
            {"k": cache["k"][i], "v": cache["v"][i]}
        h = _decode_block(cfg, tp, h, lp, layer["k"], layer["v"], cache_len)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h), cache


def _no_training(*_a, **_k):
    raise NotImplementedError("LM training (lm_loss, cross_entropy) arrives "
                              "with a later slice (ROADMAP.md §A)")


def build_lm(cfg: ModelConfig, tp: int = 1) -> ModelFns:
    cfg.validate()
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: only the dense and MoE LM "
                                  f"families are ported (ROADMAP.md §A)")
    cfg.padded_heads(tp)  # tp must be 1 until sharding is ported
    return ModelFns(
        cfg=cfg,
        init=partial(init_params, cfg, tp=tp),
        loss=_no_training,
        prefill=partial(prefill, cfg, tp),
        decode=partial(decode_token, cfg, tp),
        init_cache=partial(init_cache, cfg, tp))

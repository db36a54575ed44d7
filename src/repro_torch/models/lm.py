"""Decoder-only LM assembly for the dense, MoE, SSM (mamba2), hybrid
(hymba) and VLM (llava) families (counterpart of ``repro.models.lm``):
init, prefill and single-token decode, and :class:`ModelFns`, the bundle of
model functions every family builds (the encoder-decoder family's are in
``models.encdec``).

The layer stack is a Python loop over per-layer params (the reference
scans over params stacked on a leading L axis, and unrolls the hybrid
family).  Params are ``{"embed": (V, d), "layers": [{"ln1", "attn":
AttentionParams, "ln2", "mlp": MlpParams | "moe": MoeParams, "ssm":
Mamba2Params}, ...], "final_norm": (d,), "head": (d, V)}`` in fp32, the
``(in, out)`` layout of the reference; an SSM layer holds ``ln1`` and
``ssm`` only, a hybrid layer all but ``moe``.
``convert.lm_params_from_numpy`` carries the reference's stacked params
across.  Activations are bf16 from the embedding on.  An MoE layer's FFN is
``models.moe.moe_block`` (attention stays on B6), whose load-balance term
each block returns and the stack sums.  A hybrid layer runs attention (B6)
and the mamba2 mixer side by side on the same input, ``h + 0.5 * (attn +
ssm)``, then its MLP; its layers 0, every
``global_layer_every``-th and the last attend globally, the others within
``swa_window``.  A VLM layer is a dense layer; the VLM's prefill takes
``batch["prefix_embeds"]`` (B, n_prefix_embeds, d), the vision tower's
patch embeddings (a stub, as in the reference), which overwrite the
prompt's first positions, so a prompt holds at least ``n_prefix_embeds``
tokens.  Decode takes no prefix.

Caches: dense, MoE and VLM ``{"k", "v"}`` bf16 of shape (L, B, S, Hkv, dh) —
the stacked cache — or, with ``cfg.decode_unroll``, a tuple of per-layer
``{"k", "v"}`` of shape (B, S, Hkv, dh).  SSM: a tuple of per-layer
``ssm.Mamba2Cache``.  Hybrid: a tuple of per-layer ``{"k", "v", "ssm"}``,
K and V a ring of capacity ``min(swa_window, S)`` on a window layer and S
on a global one, prefill's token t at slot ``t mod capacity``.  Decode
writes into the caches in place and returns the same cache object.

Training: :func:`next_token_loss` (``build_lm(...).loss``) is the reference's
next-token cross entropy (:func:`cross_entropy`) over the stack's logits,
plus ``MOE_LOSS_COEF * aux / n_layers`` for the MoE family.  With
``cfg.remat == "full"`` (the only setting the port takes) and grad enabled,
each block of a non-hybrid stack runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: its activations
are recomputed in the backward, as the reference's ``jax.checkpoint`` of
the scanned block does (the reference's unrolled hybrid stack has no
checkpoint, nor has the port's).  The recompute repeats the block's bits,
an MoE block's routing and an SSM block's scan included.  Attention's
gradient is B6-bwd on the card (``kernels.flash_attn.ops.FlashAttention``):
a step of tinyllama launches B6 twice a layer (forward and recompute) and
B6-bwd once; of hymba (no remat) once each.  ``cfg.quant == "qat-int8"``
fake-quantizes every dense projection's input and f32 master weight
(``common.dense``), in training and serving alike; a bf16 serving copy of
the params would quantize the rounded weights instead, so serve QAT
models from the masters.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import COMPUTE, normal_init, rms_norm
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.tree import tree_map

LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
MOE_LOSS_COEF = 0.01


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
    layer = {"ln1": ones()}
    if cfg.family != "ssm":
        layer["attn"] = attn.init_attn(generator, d, hq, hkv, dh,
                                       cfg.qkv_bias, device=device)
        layer["ln2"] = ones()
    if cfg.family == "moe":
        layer["moe"] = init_moe(generator, d, cfg.d_ff, cfg.n_experts,
                                cfg.n_shared_experts, cfg.gated_mlp,
                                device=device)
    elif cfg.family != "ssm":
        layer["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.gated_mlp,
                                device=device)
    if cfg.family in ("ssm", "hybrid"):
        layer["ssm"] = ssm.init_ssm(generator, d, cfg.d_inner, cfg.ssm_state,
                                    cfg.n_ssm_heads, device=device)
    return layer


def global_flags(cfg: ModelConfig) -> list:
    """Hybrid: which layers attend globally (the others within
    ``swa_window``): layer 0, every ``global_layer_every``-th and the last.
    All False for the other families."""
    if cfg.family != "hybrid" or not cfg.global_layer_every:
        return [False] * cfg.n_layers
    return [i % cfg.global_layer_every == 0 or i == cfg.n_layers - 1
            for i in range(cfg.n_layers)]


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                tp: int = 1, dtype=torch.float32) -> dict:
    """Params from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (raises for CUDA without a card): fp32 masters, or with ``dtype`` the
    masters' values cast to it (``COMPUTE``, bf16, for serving).  The cast
    is made layer by layer as the params are drawn, so at most one layer's
    fp32 masters are alive at a time: qwen2.5-14b's bf16 params (30 GB) are
    made without its 59 GB of masters.  Every use of a param casts it to the
    bf16 activations first, so serving from the bf16 params gives the same
    values as serving from the masters.  The params used in f32 keep their
    masters' values: an MoE layer's router and an SSM mixer's
    ``ssm.FP32_FIELDS``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, vp = cfg.d_model, cfg.padded_vocab(tp)

    def cast(tree):
        return tree_map(lambda t: t.to(dtype), tree)

    def cast_layer(layer):
        out = cast(layer)
        if "moe" in layer:
            out["moe"] = out["moe"]._replace(router=layer["moe"].router)
        if "ssm" in layer:
            out["ssm"] = out["ssm"]._replace(**{
                f: getattr(layer["ssm"], f) for f in ssm.FP32_FIELDS})
        return out

    layers = [cast_layer(_layer_init(cfg, gen, tp, dev))
              for _ in range(cfg.n_layers)]
    return {"embed": cast(normal_init(gen, (vp, d), device=dev)),
            "layers": layers,
            "final_norm": torch.ones((d,), dtype=dtype, device=dev),
            "head": cast(normal_init(gen, (d, vp), device=dev))}


def _ffn(cfg: ModelConfig, lp, x):
    """The layer's FFN on x (B, S, d): (the dense MLP's output, a zero
    load-balance term) or the MoE block's (y, aux)."""
    if cfg.family == "moe":
        return moe_block(lp["moe"], x, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         quant=cfg.quant)
    return mlp_block(lp["mlp"], x, quant=cfg.quant), _zero(x)


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _mixer(cfg: ModelConfig, lp, x, return_cache: bool):
    """The layer's mamba2 mixer on x (B, S, d) [, its Mamba2Cache]."""
    return ssm.ssm_block(lp["ssm"], x, n_heads=cfg.n_ssm_heads,
                         head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state,
                         chunk=cfg.ssm_chunk, quant=cfg.quant,
                         return_cache=return_cache)


def _block(cfg: ModelConfig, tp: int, h, lp, *, return_kv: bool,
           is_global: bool = False):
    """One pre-norm residual block. h: (B, S, d).  Returns (h, kv, aux): kv
    is the attention's (k, v), the SSM layer's Mamba2Cache or the hybrid
    layer's ((k, v), Mamba2Cache) with ``return_kv``, else None; aux the
    MoE block's load-balance term (0 in the other families)."""
    x = rms_norm(h, lp["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        out = _mixer(cfg, lp, x, return_kv)
        return (h + out[0], out[1], _zero(h)) if return_kv else \
            (h + out, None, _zero(h))
    window = None if is_global else (cfg.swa_window or None)
    a_out = attn.attn_block(lp["attn"], x, cfg_heads=_heads(cfg, tp),
                            rope_theta=cfg.rope_theta, causal=True,
                            window=window, quant=cfg.quant,
                            return_kv=return_kv)
    kv = None
    if return_kv:
        a_out, kv = a_out
    if cfg.family == "hybrid":
        s_out = _mixer(cfg, lp, x, return_kv)
        if return_kv:
            s_out, skv = s_out
            kv = (kv, skv)
        h = h + 0.5 * (a_out + s_out)
        return h + mlp_block(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                             quant=cfg.quant), kv, _zero(h)
    h = h + a_out
    y, aux = _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps))
    return h + y, kv, aux


def check_prefix_len(n_prefix: int, seq: int) -> None:
    """Refuse a prompt shorter than the prefix embeddings that overwrite its
    first positions (the reference's ``dynamic_update_slice`` cannot take
    one either)."""
    if n_prefix > seq:
        raise ValueError(
            f"a VLM prompt of {seq} token(s) is shorter than its {n_prefix} "
            f"prefix embeddings, which overwrite its first positions; prompts "
            f"need at least {n_prefix} tokens")


def _embed(params, tokens, prefix_embeds=None):
    """The tokens' embeddings in bf16; ``prefix_embeds`` (B, P, d), when
    given, in place of the first P."""
    h = params["embed"][tokens].to(COMPUTE)
    if prefix_embeds is not None:
        check_prefix_len(prefix_embeds.shape[1], tokens.shape[1])
        h[:, :prefix_embeds.shape[1]] = prefix_embeds.to(COMPUTE)
    return h


def _stack_forward(cfg: ModelConfig, tp: int, params, h, *,
                   collect_kv: bool):
    """Runs the layer stack. Returns (h, [each layer's kv (``_block``)] or
    None, the sum of the blocks' aux terms in layer order).  Under grad,
    without ``collect_kv``, each block of a non-hybrid stack is
    checkpointed (``cfg.remat == "full"``; module docstring)."""
    remat = torch.is_grad_enabled() and not collect_kv \
        and cfg.family != "hybrid" and cfg.remat == "full"
    kvs, aux_total = [], _zero(h)
    for lp, is_global in zip(params["layers"], global_flags(cfg)):
        block = partial(_block, cfg, tp, lp=lp, return_kv=collect_kv,
                        is_global=is_global)
        if remat:
            h, kv, aux = checkpoint(block, h, use_reentrant=False)
        else:
            h, kv, aux = block(h)
        kvs.append(kv)
        aux_total = aux_total + aux
    return h, (kvs if collect_kv else None), aux_total


def _logits(params, h):
    return torch.matmul(h, params["head"].to(h.dtype))


def init_cache(cfg: ModelConfig, tp: int, batch: int, seq: int, *,
               device="cuda"):
    """Zeroed caches: stacked, or per layer with ``decode_unroll`` and for
    the SSM and hybrid families (a hybrid window layer's K and V hold
    ``min(swa_window, seq)`` slots)."""
    dev = resolve_device(device)
    _, hkv, dh = _heads(cfg, tp)

    def zeros(*lead, slots=seq):
        return torch.zeros((*lead, batch, slots, hkv, dh), dtype=COMPUTE,
                           device=dev)

    def mixer():
        return ssm.init_cache(batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state, cfg.d_inner, device=dev)

    if cfg.family == "ssm":
        return tuple(mixer() for _ in range(cfg.n_layers))
    if cfg.family == "hybrid":
        caps = [_ring_slots(cfg, g, seq) for g in global_flags(cfg)]
        return tuple({"k": zeros(slots=c), "v": zeros(slots=c),
                      "ssm": mixer()} for c in caps)
    if cfg.decode_unroll:
        return tuple({"k": zeros(), "v": zeros()}
                     for _ in range(cfg.n_layers))
    return {"k": zeros(cfg.n_layers), "v": zeros(cfg.n_layers)}


def _ring_slots(cfg: ModelConfig, is_global: bool, seq: int) -> int:
    """A hybrid layer's K/V slots after a prompt of ``seq`` tokens."""
    return seq if is_global else min(cfg.swa_window, seq)


def layer_cache(cfg: ModelConfig, kv, is_global: bool, seq: int):
    """A layer's decode cache from the kv its block returned over a prompt
    of ``seq`` tokens: K and V in bf16 (as long as the prompt); an SSM
    layer's Mamba2Cache; for a hybrid layer K and V in a ring of
    ``min(swa_window, seq)`` slots on a window layer (``seq`` on a global
    one), token t at slot ``t mod capacity``, beside its Mamba2Cache."""
    if cfg.family == "ssm":
        return kv
    if cfg.family != "hybrid":
        k, v = kv
        return {"k": k.to(COMPUTE), "v": v.to(COMPUTE)}
    (k, v), mixer = kv
    cap = _ring_slots(cfg, is_global, seq)
    return {"k": torch.roll(k[:, -cap:], seq % cap, 1).to(COMPUTE),
            "v": torch.roll(v[:, -cap:], seq % cap, 1).to(COMPUTE),
            "ssm": mixer}


def prefill(cfg: ModelConfig, tp: int, params, batch):
    """Causal forward over the prompt ``batch["tokens"]`` (B, S); returns
    (cache, last-token logits (B, V)).  K and V caches are as long as the
    prompt, a hybrid window layer's ``min(swa_window, S)``; an SSM prompt
    needs at least ``ssm.CONV_TAPS - 1`` tokens.  ``batch["prefix_embeds"]``
    (B, P, d), when given, overwrites the first P positions' embeddings
    (the VLM family; P <= S)."""
    h = _embed(params, batch["tokens"], batch.get("prefix_embeds"))
    seq = batch["tokens"].shape[1]
    h, kvs, _ = _stack_forward(cfg, tp, params, h, collect_kv=True)
    if cfg.decode_unroll or cfg.family in ("ssm", "hybrid"):
        cache = tuple(layer_cache(cfg, kv, is_global, seq)
                      for kv, is_global in zip(kvs, global_flags(cfg)))
    else:
        cache = {"k": torch.stack([k for k, _ in kvs]).to(COMPUTE),
                 "v": torch.stack([v for _, v in kvs]).to(COMPUTE)}
    h = rms_norm(h[:, -1, :], params["final_norm"], cfg.norm_eps)
    return cache, _logits(params, h)


def _mixer_step(cfg: ModelConfig, lp, cache, x):
    y, _ = ssm.ssm_decode_step(lp["ssm"], cache, x, n_heads=cfg.n_ssm_heads,
                               head_dim=cfg.ssm_head_dim,
                               n_state=cfg.ssm_state, quant=cfg.quant)
    return y


def _decode_block(cfg: ModelConfig, tp: int, h1, lp, layer, cache_len):
    """One token through one layer; ``layer`` is the layer's cache."""
    x = rms_norm(h1, lp["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return h1 + _mixer_step(cfg, lp, layer, x)
    # the reference's decode passes no window (lm.py _decode_block): a
    # hybrid window layer is limited by its ring's capacity
    a_out, _, _ = attn.decode_attn_block(
        lp["attn"], x, layer["k"], layer["v"], cache_len,
        cfg_heads=_heads(cfg, tp), rope_theta=cfg.rope_theta, quant=cfg.quant)
    if cfg.family == "hybrid":
        h1 = h1 + 0.5 * (a_out + _mixer_step(cfg, lp, layer["ssm"], x))
        return h1 + mlp_block(lp["mlp"],
                              rms_norm(h1, lp["ln2"], cfg.norm_eps),
                              quant=cfg.quant)
    h1 = h1 + a_out
    x2 = rms_norm(h1, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":  # the B tokens route as one group of (B, 1)
        return h1 + _ffn(cfg, lp, x2[:, None, :])[0][:, 0, :]
    return h1 + _ffn(cfg, lp, x2)[0]


def decode_token(cfg: ModelConfig, tp: int, params, cache, tokens1,
                 cache_len: int):
    """tokens1: (B,) the newly sampled tokens; ``cache_len`` the position
    they take.  Writes their K and V (and SSM state and conv tails) into
    ``cache`` in place; returns (logits (B, V), cache)."""
    h = _embed(params, tokens1)
    per_layer = cfg.decode_unroll or cfg.family in ("ssm", "hybrid")
    for i, lp in enumerate(params["layers"]):
        layer = cache[i] if per_layer else \
            {"k": cache["k"][i], "v": cache["v"][i]}
        h = _decode_block(cfg, tp, h, lp, layer, cache_len)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h), cache


def cross_entropy(logits, labels, true_vocab: int):
    """logits (B, S, V') in any float dtype, labels (B, S) int, -1 masked:
    the mean next-token cross entropy over the kept labels, in f32, the
    padded vocab columns (>= ``true_vocab``) at -1e30 (the reference's
    ``cross_entropy``)."""
    lg = logits.float()
    if true_vocab < lg.shape[-1]:
        col = torch.arange(lg.shape[-1], device=lg.device)
        lg = torch.where(col < true_vocab, lg, -1e30)
    lse = torch.logsumexp(lg, dim=-1)
    lab = torch.gather(lg, -1, torch.clamp_min(labels, 0)[..., None]
                       .long())[..., 0]
    mask = (labels >= 0).float()
    # a true division by a device tensor (never a reciprocal multiply)
    return torch.sum((lse - lab) * mask) / torch.clamp_min(torch.sum(mask),
                                                           1.0)


def next_token_loss(cfg: ModelConfig, tp: int, params, batch, *,
                    terms: dict | None = None):
    """The training loss on ``batch`` {"tokens", "labels" (B, S), and for
    the VLM family "prefix_embeds" (B, P, d)}: :func:`cross_entropy` of the
    stack's logits, plus ``MOE_LOSS_COEF * aux / n_layers`` for MoE (the
    reference's ``lm_loss``, whose name the reference's dead-exports
    allowlist holds, as it holds ``MOE_AUX_COEF``).  ``terms``, when given,
    receives the MoE balance term ``aux`` (detached; the launcher reports
    its last value)."""
    h = _embed(params, batch["tokens"], batch.get("prefix_embeds"))
    h, _, aux = _stack_forward(cfg, tp, params, h, collect_kv=False)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    loss = cross_entropy(_logits(params, h), batch["labels"], cfg.vocab_size)
    if cfg.family == "moe":
        loss = loss + MOE_LOSS_COEF * aux / cfg.n_layers
        if terms is not None:
            terms["balance"] = aux.detach()
    return loss


def build_lm(cfg: ModelConfig, tp: int = 1) -> ModelFns:
    cfg.validate()
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the port's LM families are "
                                  f"{LM_FAMILIES} (ROADMAP.md §A)")
    cfg.padded_heads(tp)  # tp must be 1 until sharding is ported
    return ModelFns(
        cfg=cfg,
        init=partial(init_params, cfg, tp=tp),
        loss=partial(next_token_loss, cfg, tp),
        prefill=partial(prefill, cfg, tp),
        decode=partial(decode_token, cfg, tp),
        init_cache=partial(init_cache, cfg, tp))

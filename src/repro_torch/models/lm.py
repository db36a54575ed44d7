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
``ssm`` only, a hybrid layer all but ``moe``.  With ``cfg.tie_embeddings``
there is no ``"head"``: the logits are ``h @ embed^T``, and the embedding's
gradient is the sum of its two uses.
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
``cfg.remat == "full"`` and grad enabled, each block of a non-hybrid stack
runs under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: its
activations are recomputed in the backward, as the reference's
``jax.checkpoint`` of the scanned block does (the reference's unrolled
hybrid stack has no checkpoint, nor has the port's).  ``"save_attn"``
(the reference's ``save_only_these_names("attn_out")`` policy) keeps each
attention block's output and recomputes the rest, the same ops in two
checkpoints; an SSM stack has no attention and checkpoints whole blocks.
``cfg.parallel_block`` (dense, MoE, VLM) adds the attention's and the
FFN's outputs of one normed input to the residual; the hybrid and SSM
blocks ignore it, as the reference's do (its decode step too).  The
recompute repeats the block's bits, an MoE block's routing and an SSM
block's scan included.  Attention's
gradient is B6-bwd on the card (``kernels.flash_attn.ops.FlashAttention``):
a step of tinyllama launches B6 twice a layer (forward and recompute) and
B6-bwd once; of hymba (no remat) once each.  ``cfg.quant == "qat-int8"``
fake-quantizes every dense projection's input and f32 master weight
(``common.dense``), in training and serving alike; a bf16 serving copy of
the params would quantize the rounded weights instead, so serve QAT
models from the masters.

Sharding: :func:`lm_axes` (``ModelFns.param_axes``) and
:func:`lm_cache_axes` name every param's and cache's logical axes, the
reference's trees with the stacked-layer ``None`` dropped and the layers
split into a list, as ``convert.lm_params_from_numpy`` splits the weights;
the activations are placed with ``dist.sharding.shard`` where the
reference places them.  At ``tp > 1`` heads are padded
(``ModelConfig.padded_heads``, padded query heads zero) and so are the SSM
heads (:func:`ssm_heads`) and the vocab.  Every family runs on a mesh: the
MoE block expert-parallel (``models.moe``), the SSM mixer on each rank's
heads (``models.ssm``), the hybrid's attention and mixer side by side,
its window rings placed by :func:`lm_cache_axes`, the VLM's prefix
embeddings written into the embedded batch's own rows (placed as it).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (local_block, placed_like,
                                       replicated_like, shard)
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import (COMPUTE, embed_lookup, normal_init,
                                      rms_norm)
from repro_torch.models.mlp import init_mlp, mlp_axes, mlp_block
from repro_torch.models.moe import init_moe, moe_axes, moe_block
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
    param_axes: Callable | None = None  # () -> logical-axes tree
    predict: Callable | None = None     # MRF: (params, batch) -> (B, 2)
    qat_loss: Callable | None = None    # MRF: (params, qstate, batch)
    init_qat_aux: Callable | None = None  # MRF: params -> qstate


def _heads(cfg: ModelConfig, tp: int) -> tuple:
    return (*cfg.padded_heads(tp), cfg.head_dim)


def ssm_heads(cfg: ModelConfig, tp: int) -> int:
    """SSM heads padded to a multiple of ``tp`` (the reference's
    ``_ssm_heads``); the mixer's inner width is this times its head dim."""
    return -(-cfg.n_ssm_heads // tp) * tp


def _layer_init(cfg: ModelConfig, generator, tp: int, device) -> dict:
    d = cfg.d_model
    hq, hkv, dh = _heads(cfg, tp)
    ones = partial(torch.ones, (d,), dtype=torch.float32, device=device)
    layer = {"ln1": ones()}
    if cfg.family != "ssm":
        layer["attn"] = attn.init_attn(generator, d, hq, hkv, dh,
                                       cfg.qkv_bias, device=device,
                                       true_hq=cfg.n_heads)
        layer["ln2"] = ones()
    if cfg.family == "moe":
        layer["moe"] = init_moe(generator, d, cfg.d_ff, cfg.n_experts,
                                cfg.n_shared_experts, cfg.gated_mlp,
                                device=device)
    elif cfg.family != "ssm":
        layer["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.gated_mlp,
                                device=device)
    if cfg.family in ("ssm", "hybrid"):
        nh = ssm_heads(cfg, tp)
        layer["ssm"] = ssm.init_ssm(generator, d, nh * cfg.ssm_head_dim,
                                    cfg.ssm_state, nh, device=device)
    return layer


def _layer_axes(cfg: ModelConfig) -> dict:
    layer = {"ln1": (None,)}
    if cfg.family != "ssm":
        layer["attn"] = attn.attn_axes(cfg.qkv_bias)
        layer["ln2"] = (None,)
    if cfg.family == "moe":
        layer["moe"] = moe_axes(cfg.n_shared_experts, cfg.gated_mlp)
    elif cfg.family != "ssm":
        layer["mlp"] = mlp_axes(cfg.gated_mlp)
    if cfg.family in ("ssm", "hybrid"):
        layer["ssm"] = ssm.ssm_axes()
    return layer


def lm_axes(cfg: ModelConfig) -> dict:
    """The params' logical axes, one entry per layer (the reference's
    ``lm_param_axes``, whose name its dead-exports allowlist holds)."""
    axes = {"embed": ("tp", "fsdp"),
            "layers": [_layer_axes(cfg) for _ in range(cfg.n_layers)],
            "final_norm": (None,)}
    if not cfg.tie_embeddings:
        axes["head"] = ("fsdp", "tp")
    return axes


def lm_cache_axes(cfg: ModelConfig):
    """The caches' logical axes (``init_cache``'s structure): per layer for
    the SSM and hybrid families and ``decode_unroll``, else the stacked
    ``{"k", "v"}``."""
    kv = ("batch", "cache_seq", None, None)
    if cfg.family == "ssm":
        return tuple(ssm.cache_axes() for _ in range(cfg.n_layers))
    if cfg.family == "hybrid":
        return tuple({"k": kv, "v": kv, "ssm": ssm.cache_axes()}
                     for _ in range(cfg.n_layers))
    if cfg.decode_unroll:
        return tuple({"k": kv, "v": kv} for _ in range(cfg.n_layers))
    return {"k": (None, *kv), "v": (None, *kv)}


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
    dev = resolve_device(device, meta=True)
    gen = (None if dev.type == "meta"  # shapes only: nothing to draw
           else torch.Generator(device=dev).manual_seed(seed))
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
    params = {"embed": cast(normal_init(gen, (vp, d), device=dev)),
              "layers": layers,
              "final_norm": torch.ones((d,), dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["head"] = cast(normal_init(gen, (d, vp), device=dev))
    return params


def _ffn(cfg: ModelConfig, lp, x):
    """The layer's FFN on x (B, S, d): (the dense MLP's output, a zero
    load-balance term) or the MoE block's (y, aux)."""
    if cfg.family == "moe":
        return moe_block(lp["moe"], x, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         quant=cfg.quant)
    return mlp_block(lp["mlp"], x, quant=cfg.quant), _zero(x)


def _zero(x):
    return replicated_like(torch.zeros((), dtype=torch.float32,
                                       device=x.device), x)


def _mixer(cfg: ModelConfig, tp: int, lp, x, return_cache: bool):
    """The layer's mamba2 mixer on x (B, S, d) [, its Mamba2Cache]."""
    return ssm.ssm_block(lp["ssm"], x, n_heads=ssm_heads(cfg, tp),
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
        out = _mixer(cfg, tp, lp, x, return_kv)
        return (h + out[0], out[1], _zero(h)) if return_kv else \
            (h + out, None, _zero(h))
    a_out = _attention(cfg, tp, lp, x, return_kv, is_global)
    kv = None
    if return_kv:
        a_out, kv = a_out
    if cfg.family == "hybrid":
        s_out = _mixer(cfg, tp, lp, x, return_kv)
        if return_kv:
            s_out, skv = s_out
            kv = (kv, skv)
        h = h + _residual(0.5 * (a_out + s_out))
        return h + mlp_block(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                             quant=cfg.quant), kv, _zero(h)
    h, aux = _after_attention(cfg, lp, h, a_out, x)
    return h, kv, aux


def _attention(cfg: ModelConfig, tp: int, lp, x, return_kv: bool,
               is_global: bool):
    """The layer's attention on its normed input x [, its (k, v)]."""
    window = None if is_global else (cfg.swa_window or None)
    return attn.attn_block(lp["attn"], x, cfg_heads=_heads(cfg, tp),
                           rope_theta=cfg.rope_theta, causal=True,
                           window=window, quant=cfg.quant,
                           return_kv=return_kv)


def _after_attention(cfg: ModelConfig, lp, h, a_out, x):
    """An attention family's block after its attention (h the block's
    input, x its normed input): (h out, aux).  Sequential, ``h + a_out``
    then its FFN on ``rms_norm(·, ln2)``; ``cfg.parallel_block`` (PaLM
    style, the dense, MoE and VLM families), ``h + a_out + FFN(x)``, the
    FFN on the same normed input as the attention, ``ln2`` unused."""
    if cfg.parallel_block:
        y, aux = _ffn(cfg, lp, x)
        return h + a_out + y, aux
    h = h + _residual(a_out)
    y, aux = _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps))
    return h + y, aux


def _residual(out):
    """A sublayer's output (attention's; the hybrid's ``0.5 * (attention +
    mixer)``) placed as the residual stream between blocks (``("batch",
    "act_seq", None)``; a decode step's ``("batch", None)``) before it is
    added to the stream: the tensor-parallel products' pending sums are
    reduced (under sequence parallelism scattered over the sequence)
    before the next norm, as GSPMD places them in the reference.  Left
    pending, DTensor propagates the pending sum through the norm and runs
    the FFN's products at full width on every ``model`` rank.  The
    output, not ``h + out``, is placed: DTensor adds a replicated ``h`` to
    a pending sum by splitting ``h`` into ``h / n`` on each of the ``n``
    ranks (``Partial._partition_value``), so each rank would round its
    share of the whole stream in bf16 before the all-reduce sums them —
    a rounding of the stream a layer that one process does not make (it
    moved hymba's gradients past the mesh tests' bounds).  The identity
    without a mesh."""
    return shard(out, "batch", "act_seq", None) if out.dim() == 3 else \
        shard(out, "batch", None)


def _save_attn_block(cfg: ModelConfig, tp: int, lp, is_global: bool, h):
    """``cfg.remat == "save_attn"``: one block as two checkpoints with the
    attention's output at their boundary, so the backward keeps it (one
    (B, S, d) tensor more a layer than ``"full"``; with
    ``parallel_block`` the normed input too) and recomputes the rest.  The
    ops are ``_block``'s: the loss and gradients are ``"full"``'s bits."""
    def attention_part(h):
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        a_out = _attention(cfg, tp, lp, x, False, is_global)
        return (a_out, x) if cfg.parallel_block else (a_out, None)

    a_out, x = checkpoint(attention_part, h, use_reentrant=False)
    h, aux = checkpoint(partial(_after_attention, cfg, lp), h, a_out, x,
                        use_reentrant=False)
    return h, None, aux


def check_prefix_len(n_prefix: int, seq: int) -> None:
    """Refuse a prompt shorter than the prefix embeddings that overwrite its
    first positions (the reference's ``dynamic_update_slice`` cannot take
    one either)."""
    if n_prefix > seq:
        raise ValueError(
            f"a VLM prompt of {seq} token(s) is shorter than its {n_prefix} "
            f"prefix embeddings, which overwrite its first positions; prompts "
            f"need at least {n_prefix} tokens")


def _embed(params, tokens, prefix_embeds=None,
           axes=("batch", "act_seq", None)):
    """The tokens' embeddings in bf16, placed by ``axes``;
    ``prefix_embeds`` (B, P, d), when given, in place of the first P,
    concatenated with the rest (a DTensor placed as the embeddings first;
    an in-place write into the slice has a backward that DTensor cannot
    place once the residual stream is placed inside the blocks)."""
    h = embed_lookup(params["embed"], tokens).to(COMPUTE)
    if prefix_embeds is not None:
        check_prefix_len(prefix_embeds.shape[1], tokens.shape[1])
        n = prefix_embeds.shape[1]
        h = torch.cat([placed_like(prefix_embeds.to(COMPUTE), h), h[:, n:]],
                      dim=1)
    return shard(h, *axes)


def _stack_forward(cfg: ModelConfig, tp: int, params, h, *,
                   collect_kv: bool):
    """Runs the layer stack. Returns (h, [each layer's kv (``_block``)] or
    None, the sum of the blocks' aux terms in layer order).  Under grad,
    without ``collect_kv``, each block of a non-hybrid stack is
    checkpointed (module docstring): whole (``cfg.remat == "full"``, and
    an SSM stack, which has no attention), or in two around the attention's
    output (``"save_attn"``, :func:`_save_attn_block`)."""
    remat = torch.is_grad_enabled() and not collect_kv \
        and cfg.family != "hybrid"
    split = remat and cfg.remat == "save_attn" and cfg.family != "ssm"
    kvs, aux_total = [], _zero(h)
    for lp, is_global in zip(params["layers"], global_flags(cfg)):
        block = partial(_block, cfg, tp, lp=lp, return_kv=collect_kv,
                        is_global=is_global)
        if split:
            h, kv, aux = _save_attn_block(cfg, tp, lp, is_global, h)
        elif remat:
            h, kv, aux = checkpoint(block, h, use_reentrant=False)
        else:
            h, kv, aux = block(h)
        h = shard(h, "batch", "act_seq", None)
        kvs.append(kv)
        aux_total = aux_total + aux
    return h, (kvs if collect_kv else None), aux_total


def _logits(params, h):
    """``h @ head``, or ``h @ embed^T`` for a tied head (no ``"head"``
    entry; the transposed table is placed as a head, ``("fsdp", "tp")``).
    On a mesh of more than one rank the head's ``fsdp`` rows are gathered
    for the product (:class:`_GatheredHead`); the vocab stays split over
    ``tp``."""
    head = params["head"] if "head" in params else params["embed"].t()
    head = head.to(h.dtype)
    if isinstance(head, DTensor) and head.device_mesh.size() > 1:
        logits = _GatheredHead.apply(h, head)
    else:
        logits = torch.matmul(h, head)
    axes = ("batch", None, "tp") if logits.dim() == 3 else ("batch", "tp")
    return shard(logits, *axes)


class _GatheredHead(torch.autograd.Function):
    """``h @ head`` with the head placed ``(None, "tp")`` for the product,
    its ``fsdp`` rows gathered as FSDP gathers a weight, and gathered again
    in the backward rather than kept (a (d, vocab / tp) copy, which would
    stay alive through the cross entropy's backward).  Left to DTensor, a
    batch split over two mesh dims (``("pod", "data")``) made it contract
    over the head's ``fsdp`` shard instead: the rows of a whole pod
    gathered and their (rows, seq, vocab / tp) logits pending on every
    rank (minitron ``train_4k``, 2 of 32 layers: 64.3 GiB a card).  The
    backward's products are autograd's for ``torch.matmul``."""

    @staticmethod
    def forward(ctx, h, head):
        ctx.save_for_backward(h, head)
        return torch.matmul(h, _gathered(head))

    @staticmethod
    def backward(ctx, g):
        h, head = ctx.saved_tensors
        dh = torch.matmul(g, _gathered(head).t())
        dw = torch.matmul(h.reshape(-1, h.shape[-1]).t(),
                          g.reshape(-1, g.shape[-1]))
        return dh, dw


def _gathered(head):
    return shard(head, None, "tp")


def init_cache(cfg: ModelConfig, tp: int, batch: int, seq: int, *,
               device="cuda"):
    """Zeroed caches: stacked, or per layer with ``decode_unroll`` and for
    the SSM and hybrid families (a hybrid window layer's K and V hold
    ``min(swa_window, seq)`` slots)."""
    dev = resolve_device(device, meta=True)
    _, hkv, dh = _heads(cfg, tp)

    def zeros(*lead, slots=seq):
        return torch.zeros((*lead, batch, slots, hkv, dh), dtype=COMPUTE,
                           device=dev)

    def mixer():
        nh = ssm_heads(cfg, tp)
        return ssm.init_cache(batch, nh, cfg.ssm_head_dim, cfg.ssm_state,
                              nh * cfg.ssm_head_dim, device=dev)

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

    def ring(t):  # placed by the caches' axes (``lm_cache_axes``)
        return shard(torch.roll(t[:, -cap:], seq % cap, 1).to(COMPUTE),
                     "batch", "cache_seq", None, None)

    return {"k": ring(k), "v": ring(v), "ssm": mixer}


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
        if cfg.decode_unroll and cfg.family not in ("ssm", "hybrid"):
            cache = tuple({n: shard(t, "batch", "cache_seq", None, None)
                           for n, t in layer.items()} for layer in cache)
    else:
        cache = {n: shard(torch.stack([kv[i] for kv in kvs]).to(COMPUTE),
                          "layers", "batch", "cache_seq", None, None)
                 for i, n in enumerate(("k", "v"))}
    h = rms_norm(h[:, -1, :], params["final_norm"], cfg.norm_eps)
    return cache, _logits(params, h)


def _mixer_step(cfg: ModelConfig, tp: int, lp, cache, x):
    y, _ = ssm.ssm_decode_step(lp["ssm"], cache, x,
                               n_heads=ssm_heads(cfg, tp),
                               head_dim=cfg.ssm_head_dim,
                               n_state=cfg.ssm_state, quant=cfg.quant)
    return y


def _decode_block(cfg: ModelConfig, tp: int, h1, lp, layer, cache_len):
    """One token through one layer; ``layer`` is the layer's cache."""
    x = rms_norm(h1, lp["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return h1 + _mixer_step(cfg, tp, lp, layer, x)
    # the reference's decode passes no window (lm.py _decode_block): a
    # hybrid window layer is limited by its ring's capacity
    a_out, _, _ = attn.decode_attn_block(
        lp["attn"], x, layer["k"], layer["v"], cache_len,
        cfg_heads=_heads(cfg, tp), rope_theta=cfg.rope_theta, quant=cfg.quant)
    if cfg.family == "hybrid":
        h1 = h1 + _residual(0.5 * (a_out + _mixer_step(cfg, tp, lp,
                                                       layer["ssm"], x)))
        return h1 + mlp_block(lp["mlp"],
                              rms_norm(h1, lp["ln2"], cfg.norm_eps),
                              quant=cfg.quant)
    h1 = h1 + _residual(a_out)
    x2 = rms_norm(h1, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":  # the B tokens route as one group of (B, 1)
        return h1 + _ffn(cfg, lp, x2[:, None, :])[0][:, 0, :]
    return h1 + _ffn(cfg, lp, x2)[0]


def decode_token(cfg: ModelConfig, tp: int, params, cache, tokens1,
                 cache_len: int):
    """tokens1: (B,) the newly sampled tokens; ``cache_len`` the position
    they take.  Writes their K and V (and SSM state and conv tails) into
    ``cache`` in place; returns (logits (B, V), cache)."""
    h = _embed(params, tokens1, axes=("batch", None))
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
    ``cross_entropy``).  A DTensor's vocab stays split: each rank reduces
    its own columns (:func:`_vocab_terms` in ``local_map``)."""
    lg = logits.float()
    if isinstance(lg, DTensor):
        lse, lab = _split_vocab_terms(lg, labels, true_vocab)
    else:
        lse, lab = _vocab_terms(lg, labels, true_vocab=true_vocab)
    mask = (labels >= 0).float()
    # a true division by a device tensor (never a reciprocal multiply)
    return torch.sum((lse - lab) * mask) / torch.clamp_min(torch.sum(mask),
                                                           1.0)


def _vocab_terms(lg, labels, *, true_vocab: int, offset: int = 0,
                 group=None):
    """Per token, the log-sum-exp over the vocab and the label's logit, of
    f32 logits whose last dim holds the vocab's columns ``offset`` on;
    ``group``: the ranks that hold the other columns (``None``: this rank
    holds them all, and the ops are the mesh-less ones)."""
    if offset + lg.shape[-1] > true_vocab:
        col = torch.arange(offset, offset + lg.shape[-1], device=lg.device)
        lg = torch.where(col < true_vocab, lg, -1e30)
    if group is not None:
        return _SplitVocabTerms.apply(lg, labels, offset, group)
    lse = torch.logsumexp(lg, dim=-1)
    lab = torch.gather(lg, -1, torch.clamp_min(labels, 0)[..., None]
                       .long())[..., 0]
    return lse, lab


def _split_vocab_terms(lg, labels, true_vocab: int):
    """:func:`_vocab_terms` of a DTensor's logits in ``local_map``: the rows
    as the logits are placed, the vocab split over at most one mesh dim
    (a group only where that dim has more than one rank)."""
    from torch.distributed.tensor.experimental import local_map
    mesh, last = lg.device_mesh, lg.dim() - 1
    vocab = [i for i, p in enumerate(lg.placements)
             if isinstance(p, Shard) and p.dim == last]
    if len(vocab) > 1:
        raise ValueError(f"logits split over {len(vocab)} mesh dims along "
                         f"the vocab {tuple(lg.placements)}")
    rows = [Replicate() if i in vocab else p
            for i, p in enumerate(lg.placements)]
    _, offset = local_block(lg.shape, mesh, lg.placements)
    group = (mesh.get_group(vocab[0])
             if vocab and mesh.size(vocab[0]) > 1 else None)
    terms = local_map(partial(_vocab_terms, true_vocab=true_vocab,
                              offset=offset[-1], group=group),
                      out_placements=(rows, rows),
                      in_placements=(lg.placements, rows), device_mesh=mesh)
    return terms(lg, labels.redistribute(mesh, rows))


class _SplitVocabTerms(torch.autograd.Function):
    """The log-sum-exp and the label's logit over a vocab split across
    ``group``: a max, a sum of exponentials and the owner's label logit
    each all-reduced (torch's ``logsumexp`` op for op on each rank); the
    logits' gradient ``g_lse * exp(lg - lse)``, plus ``g_lab`` at the
    label on its owner, as the mesh-less ops'."""

    @staticmethod
    def forward(ctx, lg, labels, offset, group):
        import torch.distributed as dist
        m = torch.amax(lg, dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        s = torch.sum(torch.exp(lg - m[..., None]), dim=-1)
        dist.all_reduce(s, group=group)
        lse = torch.log(s) + m
        idx = torch.clamp_min(labels, 0).long() - offset
        own = (idx >= 0) & (idx < lg.shape[-1])
        idx = torch.where(own, idx, 0)
        lab = torch.where(own, torch.gather(lg, -1, idx[..., None])[..., 0],
                          0.0)
        dist.all_reduce(lab, group=group)
        ctx.save_for_backward(lg, lse, idx, own)
        return lse, lab

    @staticmethod
    def backward(ctx, g_lse, g_lab):
        lg, lse, idx, own = ctx.saved_tensors
        grad = torch.zeros_like(lg)
        if g_lse is not None:
            grad = g_lse[..., None] * torch.exp(lg - lse[..., None])
        if g_lab is not None:
            grad = grad.scatter_add(-1, idx[..., None],
                                    torch.where(own, g_lab, 0.0)[..., None])
        return grad, None, None, None


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
    return ModelFns(
        cfg=cfg,
        init=partial(init_params, cfg, tp=tp),
        loss=partial(next_token_loss, cfg, tp),
        prefill=partial(prefill, cfg, tp),
        decode=partial(decode_token, cfg, tp),
        init_cache=partial(init_cache, cfg, tp),
        param_axes=partial(lm_axes, cfg))

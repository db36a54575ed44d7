"""Model configuration schema (counterpart of ``repro.configs.base``): the
``ModelConfig`` fields that the ``mrf``, ``dense``, ``moe``, ``ssm``
(mamba2), ``hybrid`` (hymba), ``encdec`` (seamless) and ``vlm`` (llava)
families read, and the head and vocab padding of a tensor-parallel
degree ``tp``.
"""

from __future__ import annotations

import dataclasses
import math

PORTED_FAMILIES = ("mrf", "dense", "moe", "ssm", "hybrid", "encdec",
                   "vlm")
QUANT_MODES = ("none", "qat-int8", "int8-hlo")
REMAT_MODES = ("full", "save_attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    # --- LM zoo ---
    d_model: int = 0
    n_heads: int = 0          # query heads; 0 for attention-free (mamba2)
    n_kv_heads: int = 0
    d_ff: int = 0             # per-expert FFN width for MoE; 0 for mamba2
    vocab_size: int = 0
    d_head: int = 0           # 0 -> d_model // n_heads
    swa_window: int = 0       # 0 = full attention
    qkv_bias: bool = False
    gated_mlp: bool = True    # SwiGLU (llama family); False -> squared ReLU
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    quant: str = "none"       # "none", "qat-int8" (fake-quant QAT) or
                              # "int8-hlo" (true int8 forward products)
    parallel_block: bool = False  # PaLM-style attn || FFN on one input
    remat: str = "full"       # "full": each block's activations recomputed
                              # in the backward; "save_attn": its attention
                              # output kept, the rest recomputed
    decode_unroll: bool = False  # per-layer decode caches (else stacked)
    tie_embeddings: bool = False  # the head is the embedding: logits
                                  # h @ embed^T, one (V, d) parameter
    # --- MoE (family == "moe") ---
    n_experts: int = 0        # routed experts
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (families "ssm" and "hybrid") ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    global_layer_every: int = 0  # hybrid: every k-th layer attends globally
    # --- encoder-decoder (family == "encdec") ---
    n_enc_layers: int = 0     # bidirectional encoder layers over the frames
    # --- multimodal stub frontend (family == "vlm") ---
    n_prefix_embeds: int = 0  # precomputed patch embeddings before the text
    # --- MRF reconstruction nets (family == "mrf") ---
    mrf_n_frames: int = 0     # fingerprint frames; input dim = 2 * frames
    mrf_hidden: tuple = ()    # hidden widths ((T1, T2) head appended)

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the ``long_500k`` decode cell (a bounded state a
        token: the SSM and hybrid families)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def padded_heads(self, tp: int = 1) -> tuple:
        """(query heads, kv heads) padded so both divide ``tp`` (the
        reference's rule): kv heads are group-replicated up to ``tp`` where
        they do not divide it, query heads zero-padded up to a multiple of
        ``tp`` (and of the kv heads).  With tp=1 the exact architecture."""
        if self.n_heads == 0:
            return (0, 0)
        hq = math.ceil(self.n_heads / tp) * tp
        if self.n_kv_heads % tp == 0 and hq % self.n_kv_heads == 0 \
                and self.n_heads % tp == 0:
            return (self.n_heads, self.n_kv_heads)
        hkv = tp if tp > 1 else self.n_kv_heads
        while hq % hkv:  # the grouping must divide
            hq += tp
        return (hq, hkv)

    def padded_vocab(self, tp: int = 1) -> int:
        return math.ceil(self.vocab_size / tp) * tp

    def validate(self):
        if self.family not in PORTED_FAMILIES:
            raise ValueError(f"{self.name}: unknown family {self.family!r}; "
                             f"the port has {PORTED_FAMILIES}")
        if self.family == "mrf":
            if self.mrf_n_frames <= 0 or not self.mrf_hidden:
                raise ValueError(f"{self.name}: mrf configs need frames and "
                                 f"hidden widths")
            return self
        if min(self.n_layers, self.d_model, self.vocab_size) <= 0:
            raise ValueError(f"{self.name}: LM configs need positive "
                             f"layers, width and vocab")
        if self.family in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError(f"{self.name}: {self.family} configs need a "
                             f"positive ssm_state")
        if self.family != "ssm":
            self._validate_attention()
        if self.family == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError(f"{self.name}: MoE configs need experts and a "
                             f"positive top_k")
        if self.quant not in QUANT_MODES:
            raise ValueError(f"{self.name}: quant={self.quant!r} not in "
                             f"{QUANT_MODES}")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"{self.name}: remat={self.remat!r} not in "
                             f"{REMAT_MODES}")
        if self.tie_embeddings and self.family == "encdec":
            raise ValueError(f"{self.name}: the encoder-decoder's head is "
                             f"its own (models.encdec)")
        return self

    def _validate_attention(self) -> None:
        """Heads and FFN of a family with attention layers (all but
        ``ssm``, which has neither)."""
        if min(self.n_heads, self.n_kv_heads, self.d_ff) <= 0:
            raise ValueError(f"{self.name}: {self.family} configs need "
                             f"positive heads and d_ff")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: {self.n_heads} query heads do not "
                             f"group over {self.n_kv_heads} kv heads")
        if self.head_dim * self.n_heads < self.d_model and not self.d_head:
            raise ValueError(f"{self.name}: heads do not cover d_model")
        if self.head_dim % 2:
            raise ValueError(f"{self.name}: RoPE needs an even head dim")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One shape of the dry-run's sweep (the reference's ``ShapeCell``):
    ``global_batch`` sequences of ``seq_len`` tokens, trained, prefilled,
    or decoded one token a sequence against a cache of ``seq_len``."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train", "prefill" or "decode"


# the reference's TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K and
# ALL_CELLS; renamed, as its dead-exports allowlist holds those names
CELL_TRAIN_4K = ShapeCell("train_4k", 4_096, 256, "train")
CELL_PREFILL_32K = ShapeCell("prefill_32k", 32_768, 32, "prefill")
CELL_DECODE_32K = ShapeCell("decode_32k", 32_768, 128, "decode")
CELL_LONG_500K = ShapeCell("long_500k", 524_288, 1, "decode")
SHAPE_CELLS = (CELL_TRAIN_4K, CELL_PREFILL_32K, CELL_DECODE_32K,
               CELL_LONG_500K)


def cells_for(cfg: ModelConfig) -> list:
    """The cells an LM arch runs: every one, but ``long_500k`` only for a
    sub-quadratic arch (the reference's rule)."""
    return [c for c in SHAPE_CELLS
            if c.name != "long_500k" or cfg.sub_quadratic]


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count, tp=1: the reference's ``param_count``.
    Exact for the port's dense, MoE, VLM and encoder-decoder models (a
    decoder layer holds three RMSNorm gains, an encoder layer two).  For
    ``ssm`` and ``hybrid`` it leaves out the conv taps, ``CONV_TAPS *
    (d_inner + 2 * ssm_state)`` a layer, and for ``ssm`` it counts two
    RMSNorm gains a layer where the layer holds one, as the reference
    does.  A tied head (``tie_embeddings``; the reference has none) is
    the embedding, counted once."""
    if cfg.family == "mrf":
        sizes = (2 * cfg.mrf_n_frames, *cfg.mrf_hidden, 2)
        return sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:]))
    cfg.validate()
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    if cfg.qkv_bias:
        attn += (hq + 2 * hkv) * dh
    ffn = d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    # in projections x, z, B, C, dt; out projection; A, D, dt_bias; gate norm
    ssm = d * (2 * di + 2 * ns + nh) + di * d + 3 * nh + di
    if cfg.family == "encdec":
        dec = 2 * attn + ffn + 3 * d  # self- and cross-attention
        enc = attn + ffn + 2 * d
        return (cfg.vocab_size * d * 2 + cfg.n_layers * dec
                + cfg.n_enc_layers * enc + 2 * d)
    if cfg.family == "ssm":
        per_layer = 2 * d + ssm
    elif cfg.family == "hybrid":
        per_layer = 2 * d + attn + ssm + ffn
    elif cfg.family == "moe":
        per_layer = 2 * d + attn + d * cfg.n_experts  # router
        per_layer += (cfg.n_experts + cfg.n_shared_experts) * ffn
    else:
        per_layer = 2 * d + attn + ffn
    tables = 1 if cfg.tie_embeddings else 2  # embedding [and head]
    return cfg.vocab_size * d * tables + cfg.n_layers * per_layer + d


def active_param_count(cfg: ModelConfig) -> int:
    """Params a token uses (MoE: its top_k routed and the shared experts)."""
    if cfg.family != "moe":
        return param_count(cfg)
    ffn = cfg.d_model * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    return param_count(cfg) - cfg.n_layers * (cfg.n_experts - cfg.top_k) * ffn

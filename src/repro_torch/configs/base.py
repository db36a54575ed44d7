"""Model configuration schema (counterpart of ``repro.configs.base``): the
``ModelConfig`` fields that the ``mrf``, ``dense`` and ``moe`` families
read.

The other LM families (``ssm``, ``hybrid``, ``encdec``, ``vlm``) are not
ported yet: ``validate`` refuses them (ROADMAP.md §A).  Sharding is not
ported either, so the tensor-parallel degree ``tp`` must be 1.
"""

from __future__ import annotations

import dataclasses
import math

PORTED_FAMILIES = ("mrf", "dense", "moe")


def _check_tp(tp: int) -> None:
    if tp != 1:
        raise NotImplementedError(
            f"tp={tp}: the port runs on one card until sharding is ported "
            f"(ROADMAP.md §A)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    # --- LM zoo (family "dense" or "moe") ---
    d_model: int = 0
    n_heads: int = 0          # query heads
    n_kv_heads: int = 0
    d_ff: int = 0             # per-expert FFN width for MoE
    vocab_size: int = 0
    d_head: int = 0           # 0 -> d_model // n_heads
    swa_window: int = 0       # 0 = full attention
    qkv_bias: bool = False
    gated_mlp: bool = True    # SwiGLU (llama family); False -> squared ReLU
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    quant: str = "none"       # only "none" until the LM-training slice
    decode_unroll: bool = False  # per-layer decode caches (else stacked)
    # --- MoE (family == "moe") ---
    n_experts: int = 0        # routed experts
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- MRF reconstruction nets (family == "mrf") ---
    mrf_n_frames: int = 0     # fingerprint frames; input dim = 2 * frames
    mrf_hidden: tuple = ()    # hidden widths ((T1, T2) head appended)

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    def padded_heads(self, tp: int = 1) -> tuple:
        """(query heads, kv heads); with tp=1 the exact architecture."""
        _check_tp(tp)
        return (self.n_heads, self.n_kv_heads)

    def padded_vocab(self, tp: int = 1) -> int:
        _check_tp(tp)
        return math.ceil(self.vocab_size / tp) * tp

    def validate(self):
        if self.family not in PORTED_FAMILIES:
            raise ValueError(
                f"{self.name}: family {self.family!r} is not ported yet; "
                f"the port has {PORTED_FAMILIES} (see ROADMAP.md §A)")
        if self.family == "mrf":
            if self.mrf_n_frames <= 0 or not self.mrf_hidden:
                raise ValueError(f"{self.name}: mrf configs need frames and "
                                 f"hidden widths")
            return self
        if min(self.n_layers, self.d_model, self.n_heads, self.n_kv_heads,
               self.d_ff, self.vocab_size) <= 0:
            raise ValueError(f"{self.name}: LM configs need positive "
                             f"layers, widths, heads and vocab")
        if self.family == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError(f"{self.name}: MoE configs need experts and a "
                             f"positive top_k")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: {self.n_heads} query heads do not "
                             f"group over {self.n_kv_heads} kv heads")
        if self.head_dim * self.n_heads < self.d_model and not self.d_head:
            raise ValueError(f"{self.name}: heads do not cover d_model")
        if self.head_dim % 2:
            raise ValueError(f"{self.name}: RoPE needs an even head dim")
        if self.quant != "none":
            raise NotImplementedError(
                f"{self.name}: quant={self.quant!r} arrives with the "
                f"LM-training slice (ROADMAP.md §A)")
        return self


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (exact for the port's models, tp=1)."""
    if cfg.family == "mrf":
        sizes = (2 * cfg.mrf_n_frames, *cfg.mrf_hidden, 2)
        return sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:]))
    cfg.validate()
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    if cfg.qkv_bias:
        attn += (hq + 2 * hkv) * dh
    ffn = d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    per_layer = 2 * d + attn
    if cfg.family == "moe":
        per_layer += d * cfg.n_experts  # router
        per_layer += (cfg.n_experts + cfg.n_shared_experts) * ffn
    else:
        per_layer += ffn
    return cfg.vocab_size * d * 2 + cfg.n_layers * per_layer + d


def active_param_count(cfg: ModelConfig) -> int:
    """Params a token uses (MoE: its top_k routed and the shared experts)."""
    if cfg.family != "moe":
        return param_count(cfg)
    ffn = cfg.d_model * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    return param_count(cfg) - cfg.n_layers * (cfg.n_experts - cfg.top_k) * ffn

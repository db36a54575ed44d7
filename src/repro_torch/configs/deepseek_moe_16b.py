"""deepseek-moe-16b — 28L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert,
fine-grained) vocab=102400, MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]  (the HF checkpoint's dense layer-0 FFN is modelled as
MoE like the rest, as the reference does)"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import smoke_of

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400, n_experts=64, top_k=6, n_shared_experts=2,
).validate()


def smoke() -> ModelConfig:
    return smoke_of(CONFIG)

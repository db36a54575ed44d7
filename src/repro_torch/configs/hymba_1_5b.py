"""hymba-1.5b — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
parallel attn+mamba heads, SWA(1024) + 3 global full-attention layers
(first / middle / last; meta-tokens omitted, as in the reference),
ssm_state=16. [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import smoke_of

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, d_head=64, ssm_state=16, ssm_head_dim=64,
    swa_window=1024, global_layer_every=16,
).validate()


def smoke() -> ModelConfig:
    return smoke_of(CONFIG)

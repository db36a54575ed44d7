"""qwen2.5-14b — 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064,
GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import smoke_of

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab_size=152064, qkv_bias=True, d_head=128,
).validate()


def smoke() -> ModelConfig:
    return smoke_of(CONFIG)

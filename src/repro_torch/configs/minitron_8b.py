"""minitron-8b — 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000,
pruned nemotron (squared-ReLU non-gated FFN). [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import smoke_of

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
    vocab_size=256000, gated_mlp=False,
).validate()


def smoke() -> ModelConfig:
    return smoke_of(CONFIG)

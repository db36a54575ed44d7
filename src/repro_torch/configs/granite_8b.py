"""granite-8b — 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152,
llama-arch, code. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import smoke_of

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=49152,
).validate()


def smoke() -> ModelConfig:
    return smoke_of(CONFIG)

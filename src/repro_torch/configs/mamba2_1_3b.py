"""mamba2-1.3b — 48L d_model=2048, attention-free SSD (state-space duality),
ssm_state=128, the LM head tied to the embedding (``tie_embeddings`` in
state-spaces/mamba2-1.3b's config). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import smoke_of

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=256, tie_embeddings=True,
).validate()


def smoke() -> ModelConfig:
    return smoke_of(CONFIG)

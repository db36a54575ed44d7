"""seamless-m4t-large-v2 — enc-dec 24L+24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206, multimodal.  Backbone only, as in the reference: the speech
frontend is a stub, the encoder takes precomputed frame embeddings
(S_enc = seq/4, ``models.encdec.enc_len_for``).
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import smoke_of

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, d_head=64,
).validate()


def smoke() -> ModelConfig:
    return smoke_of(CONFIG)

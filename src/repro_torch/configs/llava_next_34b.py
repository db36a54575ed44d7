"""llava-next-34b — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
anyres tiling VLM.  Backbone only, as in the reference: the vision tower is
a stub, the prompt's first positions take precomputed patch embeddings (5
anyres tiles x 576 = 2880 tokens).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import smoke_of

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, d_head=128, n_prefix_embeds=2880,
).validate()


def smoke() -> ModelConfig:
    return smoke_of(CONFIG)

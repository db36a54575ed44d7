"""Reduced same-family smoke variants of the LM configs: tiny widths, two
layers, small vocab, few experts, a small SSM state and chunk, a window of
8, two encoder layers, 8 prefix embeddings (counterpart of
``repro.configs.smoke``, field for field).  A smoke model's head is its
own: the reference's smoke models, which the tests hold the port's
against, have no tied head."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def smoke_of(cfg: ModelConfig) -> ModelConfig:
    kw = dict(name=cfg.name + "-smoke", n_layers=2, d_model=64, d_head=16,
              d_ff=0 if cfg.d_ff == 0 else 128, vocab_size=256,
              tie_embeddings=False)
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=2)
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2),
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=8)
    if cfg.swa_window:
        kw.update(swa_window=8)
    if cfg.global_layer_every:
        kw.update(global_layer_every=2)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2)
    if cfg.n_prefix_embeds:
        kw.update(n_prefix_embeds=8)
    return dataclasses.replace(cfg, **kw).validate()

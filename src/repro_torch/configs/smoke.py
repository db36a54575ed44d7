"""Reduced same-family smoke variants of the LM configs: tiny widths, two
layers, small vocab, few experts (counterpart of ``repro.configs.smoke``)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def smoke_of(cfg: ModelConfig) -> ModelConfig:
    kw = dict(name=cfg.name + "-smoke", n_layers=2, d_model=64, d_head=16,
              d_ff=128, vocab_size=256, n_heads=4, n_kv_heads=2)
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2),
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.swa_window:
        kw.update(swa_window=8)
    return dataclasses.replace(cfg, **kw).validate()

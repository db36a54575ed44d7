"""Architecture registry (counterpart of ``repro.models.registry``):
``ModelConfig`` -> :class:`~repro_torch.models.lm.ModelFns`, by family:
every family of the reference (``mrf``, ``dense``, ``moe``, ``ssm``,
``hybrid``, ``vlm`` and ``encdec``), and the caches' logical axes."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import build_encdec, encdec_cache_axes
from repro_torch.models.lm import ModelFns, build_lm, lm_cache_axes
from repro_torch.models.mrf import build_mrf


def build(cfg: ModelConfig, tp: int = 1) -> ModelFns:
    if cfg.family == "mrf":
        return build_mrf(cfg)
    if cfg.family == "encdec":
        return build_encdec(cfg, tp)
    return build_lm(cfg, tp)


def cache_axes(cfg: ModelConfig):
    if cfg.family == "mrf":
        raise NotImplementedError("mrf nets are feed-forward: no decode cache")
    if cfg.family == "encdec":
        return encdec_cache_axes(cfg)
    return lm_cache_axes(cfg)

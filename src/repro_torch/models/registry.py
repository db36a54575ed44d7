"""Architecture registry (counterpart of ``repro.models.registry``):
``ModelConfig`` -> :class:`~repro_torch.models.lm.ModelFns`, by family.
The port has the ``mrf``, ``dense``, ``moe``, ``ssm`` and ``hybrid``
families; the others raise."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM_FAMILIES, ModelFns, build_lm
from repro_torch.models.mrf import build_mrf


def build(cfg: ModelConfig, tp: int = 1) -> ModelFns:
    if cfg.family == "mrf":
        return build_mrf(cfg)
    if cfg.family in LM_FAMILIES:
        return build_lm(cfg, tp)
    raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                              f"ported yet (ROADMAP.md §A)")

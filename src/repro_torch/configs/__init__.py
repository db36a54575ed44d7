"""Architecture configs of the port: the two MRF nets and the dense LM
family.  The other LM families (MoE, SSM, hybrid, encoder-decoder, VLM)
arrive with later slices."""
from repro_torch.configs import (granite_8b, minitron_8b, mrf_fpga,
                                 mrf_original, qwen2_5_14b, tinyllama_1_1b)
from repro_torch.configs.base import ModelConfig

ARCHS = {m.CONFIG.name: m for m in (
    tinyllama_1_1b, granite_8b, qwen2_5_14b, minitron_8b,
    mrf_fpga, mrf_original)}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not in the port yet (its family "
                       f"arrives with a later slice, ROADMAP.md §A); known: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()

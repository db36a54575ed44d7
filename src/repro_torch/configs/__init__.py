"""Architecture configs of the port: the two MRF nets and the dense, MoE,
SSM (mamba2), hybrid (hymba), encoder-decoder (seamless) and VLM (llava)
LM families — every arch of the reference."""
from repro_torch.configs import (deepseek_moe_16b, granite_8b, hymba_1_5b,
                                 llava_next_34b, mamba2_1_3b, minitron_8b,
                                 mrf_fpga, mrf_original, phi35_moe_42b,
                                 qwen2_5_14b, seamless_m4t_large_v2,
                                 tinyllama_1_1b)
from repro_torch.configs.base import ModelConfig, cells_for

ARCHS = {m.CONFIG.name: m for m in (
    phi35_moe_42b, deepseek_moe_16b, tinyllama_1_1b, granite_8b,
    qwen2_5_14b, minitron_8b, mamba2_1_3b, hymba_1_5b,
    seamless_m4t_large_v2, llava_next_34b, mrf_fpga, mrf_original)}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()


def lm_archs() -> list:
    """The LM archs (every one but the MRF nets), sorted: the dry-run's
    default sweep."""
    return sorted(n for n, m in ARCHS.items() if m.CONFIG.family != "mrf")

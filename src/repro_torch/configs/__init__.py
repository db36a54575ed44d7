"""Architecture configs of the port: the two MRF nets.  The LM zoo's archs
arrive with a later slice."""
from repro_torch.configs import mrf_fpga, mrf_original
from repro_torch.configs.base import ModelConfig

ARCHS = {m.CONFIG.name: m for m in (mrf_fpga, mrf_original)}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not in this slice of the port "
                       f"(the LM zoo arrives with a later slice); known: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()

"""The Barbieri-et-al original 9-layer MRF reconstruction MLP (the software
baseline the paper adapts down to the FPGA budget)."""
import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mrf_fpga import N_FRAMES
from repro_torch.core import mrf_net

CONFIG = ModelConfig(
    name="mrf-original", family="mrf",
    n_layers=len(mrf_net.ORIGINAL_HIDDEN) + 1,
    mrf_n_frames=N_FRAMES, mrf_hidden=mrf_net.ORIGINAL_HIDDEN,
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(CONFIG, mrf_n_frames=16)

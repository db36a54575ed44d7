"""The paper's own model: the FPGA-adapted MRF reconstruction MLP
(see ``repro_torch.core.mrf_net``)."""
import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mrf_net

N_FRAMES = 32

CONFIG = ModelConfig(
    name="mrf-fpga", family="mrf",
    n_layers=len(mrf_net.ADAPTED_HIDDEN) + 1,
    mrf_n_frames=N_FRAMES, mrf_hidden=mrf_net.ADAPTED_HIDDEN,
).validate()


def smoke() -> ModelConfig:
    """CPU-runnable reduction: fewer fingerprint frames, same topology."""
    return dataclasses.replace(CONFIG, mrf_n_frames=16)

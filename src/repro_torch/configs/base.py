"""Model configuration schema: the ``ModelConfig`` fields the ``mrf`` family
uses (counterpart of ``repro.configs.base``).  The LM fields arrive with
the LM zoo."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    # --- MRF reconstruction nets (family == "mrf") ---
    mrf_n_frames: int = 0     # fingerprint frames; input dim = 2 * frames
    mrf_hidden: tuple = ()    # hidden widths ((T1, T2) head appended)

    def validate(self):
        if self.family != "mrf":
            raise ValueError(f"{self.name}: family {self.family!r} arrives "
                             f"with the LM zoo slice of the port")
        if self.mrf_n_frames <= 0 or not self.mrf_hidden:
            raise ValueError(f"{self.name}: mrf configs need frames and "
                             f"hidden widths")
        return self

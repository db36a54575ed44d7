"""Numpy -> port conversions: how parameters held by the JAX package (passed
as numpy arrays) become the port's tensors, unchanged in value and layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qat import Int8Layer
from repro_torch.kernels.common import resolve_device


def params_from_numpy(layers, device="cuda") -> list:
    """``[{"w": (in, out), "b": (out,)}]`` ndarrays -> fp32 tensors."""
    dev = resolve_device(device)
    return [{k: torch.from_numpy(np.array(layer[k], np.float32)).to(dev)
             for k in ("w", "b")} for layer in layers]


def int_layers_from_numpy(layers, device="cuda") -> list:
    """``[{"w_q", "b_q", "s_in", "s_w", "s_out" (None on the head)}]``
    ndarrays -> :class:`Int8Layer`s."""
    dev = resolve_device(device)

    def t(arr, dtype):
        return torch.from_numpy(np.array(arr, dtype)).to(dev)

    return [Int8Layer(w_q=t(layer["w_q"], np.int8),
                      b_q=t(layer["b_q"], np.int32),
                      s_in=t(layer["s_in"], np.float32),
                      s_w=t(layer["s_w"], np.float32),
                      s_out=(None if layer.get("s_out") is None
                             else t(layer["s_out"], np.float32)))
            for layer in layers]

"""Numpy -> port conversions: how parameters held by the JAX package (passed
as numpy arrays) become the port's tensors, unchanged in value and layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qat import Int8Layer
from repro_torch.kernels.common import resolve_device
from repro_torch.optim.optimizers import AdamState, SgdState
from repro_torch.train.step import TrainState


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


def _step(step, dev) -> torch.Tensor:
    return torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev)


def adam_state_from_numpy(step, mu, nu, device="cuda") -> AdamState:
    """The step counter and the ``[{"w", "b"}]`` moments -> ``AdamState``."""
    dev = resolve_device(device)
    return AdamState(step=_step(step, dev), mu=params_from_numpy(mu, dev),
                     nu=params_from_numpy(nu, dev))


def sgd_state_from_numpy(step, momentum=None, device="cuda") -> SgdState:
    """The step counter and the optional momentum -> ``SgdState``."""
    dev = resolve_device(device)
    return SgdState(step=_step(step, dev),
                    momentum=(None if momentum is None
                              else params_from_numpy(momentum, dev)))


def qstate_from_numpy(act_absmax, device="cuda") -> dict:
    """The QAT observers ``(n_layers,)`` -> the port's QAT state."""
    return {"act_absmax": torch.from_numpy(
        np.array(act_absmax, np.float32)).to(resolve_device(device))}


def train_state_from_numpy(step, params, opt_state, *, aux=None,
                           device="cuda") -> TrainState:
    """A ``TrainState`` from the step counter and params as numpy, the
    optimizer state built by :func:`adam_state_from_numpy` /
    :func:`sgd_state_from_numpy`, and the optional QAT observers as numpy."""
    dev = resolve_device(device)
    return TrainState(step=_step(step, dev),
                      params=params_from_numpy(params, dev),
                      opt_state=opt_state, ef_residual=None,
                      aux=None if aux is None else qstate_from_numpy(aux, dev))

"""The Barbieri-et-al MRF reconstruction MLP and the paper's FPGA-adapted
variant (counterpart of ``repro.core.mrf_net``).

Original net: nine fully connected layers, ReLU on hidden layers, linear
output producing (T1, T2).  Adapted net: the first two hidden layers
removed so the whole network + backprop fits the ALVEO U250 budget.

Params are a list of ``{"w": (in, out), "b": (out,)}`` tensors — the JAX
package's ``(in, out)`` layout, not ``nn.Linear``'s — so arrays cross
between the packages as numpy with no transposes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

# Adapted: sum(ceil(n/16) for n in (64,64,32,16,16,16,2)) * 4 = 56 forward
# cycles, matching the paper.
ADAPTED_HIDDEN = (64, 64, 32, 16, 16, 16)
# Original = two extra layers in front ("the first two layers were removed").
ORIGINAL_HIDDEN = (128, 128) + ADAPTED_HIDDEN
N_TARGETS = 2  # (T1, T2), normalised


def layer_sizes(n_frames: int, hidden: Sequence[int] = ADAPTED_HIDDEN) -> tuple:
    """Full (in, hidden..., out) size tuple. Input = [Re | Im] of the signal."""
    return (2 * n_frames, *hidden, N_TARGETS)


def init_params(generator: torch.Generator, sizes: Sequence[int],
                dtype=torch.float32) -> list:
    """He-uniform init, biases zero, on ``generator``'s device.

    Draws differ from ``repro.core.mrf_net.init_params`` (Philox, not
    threefry); tests hand both packages the same numpy arrays instead.
    """
    device = generator.device
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        bound = math.sqrt(6.0 / n_in)
        w = torch.empty((n_in, n_out), dtype=dtype, device=device)
        w.uniform_(-bound, bound, generator=generator)
        params.append({"w": w, "b": torch.zeros((n_out,), dtype=dtype,
                                                device=device)})
    return params


def forward(params, x: torch.Tensor, *, return_hidden: bool = False):
    """ReLU MLP forward. x: (..., 2*n_frames) -> (..., 2)."""
    hidden = []
    h = x
    for i, layer in enumerate(params):
        z = h @ layer["w"] + layer["b"]
        last = i == len(params) - 1
        h = z if last else torch.relu(z)
        if return_hidden:
            hidden.append(h)
    return (h, hidden) if return_hidden else h


def mse_loss(params, x, y, forward_fn=forward) -> torch.Tensor:
    pred = forward_fn(params, x)
    return torch.mean(torch.square(pred - y))


def param_count(params) -> int:
    return sum(int(t.numel()) for layer in params for t in layer.values())


def node(x, w, b, activation=torch.relu):
    """Eq. (1) of the paper: y = sigma(sum_i x_i w_i + b) for one node."""
    return activation(torch.dot(x, w) + b)

"""Quantization-aware training and full-integer int8 export for the MRF net
(counterpart of ``repro.core.qat``).

Scheme (the paper's 'full integer' network): symmetric int8 with
zero-point 0; weights quantized per output channel from their live absmax;
activations quantized per tensor with an EMA-calibrated absmax observer;
straight-through estimator for gradients; export to int8 weights, int32
biases (scale = s_x * s_w) and fp32 requantization multipliers.

:func:`int_forward` is the port's plain integer oracle: the CUDA kernels in
``kernels/qat_dense`` must match it bit for bit.  The ``.npz`` artifact
format is byte-compatible with ``repro.core.qat`` in both directions.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 8
    ema: float = 0.99
    per_channel_weights: bool = True

    @property
    def qmax(self) -> float:
        return float(2 ** (self.bits - 1) - 1)


def _round_ste(x):
    return x + (torch.round(x) - x).detach()


def _clip(x, lo: float, hi: float):
    """``jnp.clip`` with its gradient: a value that meets a bound exactly
    gets half the gradient (``torch.clamp`` would pass all of it).  After
    the rounding every x / s in [qmax - 0.5, qmax + 0.5) meets the bound."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def fake_quantize(x, scale, qmax: float = 127.0):
    """Symmetric fake-quant with STE. ``scale`` broadcasts against x."""
    s = torch.clamp_min(scale, 1e-12)
    q = _clip(_round_ste(x / s), -qmax - 1, qmax)
    return q * s


def weight_scales(w, cfg: QuantConfig):
    if cfg.per_channel_weights:
        return torch.amax(torch.abs(w), dim=0, keepdim=True) / cfg.qmax
    return torch.amax(torch.abs(w)) / cfg.qmax


# ---------------------------------------------------------------------------
# QAT state (activation observers) and the fake-quantized forward.
# ---------------------------------------------------------------------------

def init_qat_state(n_layers: int, *, device="cuda") -> dict:
    """One activation absmax observer per layer input."""
    return {"act_absmax": torch.ones((n_layers,), dtype=torch.float32,
                                     device=resolve_device(device))}


def forward_qat(params, qstate, x, cfg: QuantConfig | None = None, *,
                train: bool = True):
    """Fake-quantized MLP forward; returns (output, new_qstate).

    In eval (``train=False``) the observers freeze.  The output layer is
    linear and its output is not fake-quantized.
    """
    cfg = cfg or QuantConfig()
    absmax = qstate["act_absmax"]
    new_absmax = []
    h = x
    for i, layer in enumerate(params):
        cur = torch.amax(torch.abs(h)) + 1e-12
        obs = (cfg.ema * absmax[i] + (1.0 - cfg.ema) * cur) if train \
            else absmax[i]
        new_absmax.append(obs)
        a_scale = obs.detach() / cfg.qmax
        hq = fake_quantize(h, a_scale, cfg.qmax)
        wq = fake_quantize(layer["w"], weight_scales(layer["w"], cfg),
                           cfg.qmax)
        z = hq @ wq + layer["b"]
        h = z if i == len(params) - 1 else torch.relu(z)
    return h, {"act_absmax": torch.stack(new_absmax)}


# ---------------------------------------------------------------------------
# Full-integer export + the integer oracle.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Int8Layer:
    w_q: torch.Tensor             # int8  (in, out)
    b_q: torch.Tensor             # int32 (out,)   scale = s_x * s_w
    s_in: torch.Tensor            # fp32 0-d — input activation scale
    s_w: torch.Tensor             # fp32 (out,) — per-channel weight scale
    s_out: torch.Tensor | None    # fp32 0-d output act scale (None = float head)

    @functools.cached_property
    def b_absmax(self) -> float:
        """max |b_q| as a host float, read once (the fp32-exactness guard of
        ``ops.int_forward_lax`` needs it on every call)."""
        return float(self.b_q.abs().max()) if self.b_q.numel() else 0.0


def export_int8(params, qstate, cfg: QuantConfig | None = None) -> list:
    """Freeze a QAT-trained net into full-integer layers."""
    cfg = cfg or QuantConfig()
    layers = []
    absmax = qstate["act_absmax"]
    for i, layer in enumerate(params):
        s_in = absmax[i] / cfg.qmax
        s_w = torch.squeeze(weight_scales(layer["w"], cfg), 0)  # (out,)
        w_q = torch.clamp(torch.round(layer["w"] / torch.clamp_min(s_w, 1e-12)),
                          -128, 127).to(torch.int8)
        b_q = torch.round(layer["b"] / torch.clamp_min(s_in * s_w, 1e-12)
                          ).to(torch.int32)
        last = i == len(params) - 1
        s_out = None if last else (absmax[i + 1] / cfg.qmax).float()
        layers.append(Int8Layer(w_q=w_q.detach(), b_q=b_q.detach(),
                                s_in=s_in.float().detach(),
                                s_w=s_w.float().detach(),
                                s_out=None if last else s_out.detach()))
    return layers


def save_int8_artifact(path, int_layers: Sequence[Int8Layer]) -> pathlib.Path:
    """Persist a full-integer network as one servable ``.npz`` artifact, in
    ``repro.core.qat.save_int8_artifact``'s format.  Returns the path
    written (``.npz`` is appended when missing)."""
    path = pathlib.Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    arrs = {"n_layers": np.int64(len(int_layers))}
    for i, layer in enumerate(int_layers):
        arrs[f"w_q_{i}"] = layer.w_q.detach().cpu().numpy()
        arrs[f"b_q_{i}"] = layer.b_q.detach().cpu().numpy()
        arrs[f"s_in_{i}"] = layer.s_in.detach().cpu().numpy()
        arrs[f"s_w_{i}"] = layer.s_w.detach().cpu().numpy()
        if layer.s_out is not None:
            arrs[f"s_out_{i}"] = layer.s_out.detach().cpu().numpy()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrs)
    return path


def load_int8_artifact(path, *, device="cuda") -> list:
    """Load a ``save_int8_artifact`` file (from either package) onto
    ``device``; values round-trip bit-exactly."""
    dev = resolve_device(device)

    def t(arr, dtype):
        return torch.from_numpy(np.asarray(arr, dtype)).to(dev)

    layers = []
    with np.load(path) as z:
        for i in range(int(z["n_layers"])):
            s_out = (t(z[f"s_out_{i}"], np.float32)
                     if f"s_out_{i}" in z.files else None)
            layers.append(Int8Layer(
                w_q=t(z[f"w_q_{i}"], np.int8), b_q=t(z[f"b_q_{i}"], np.int32),
                s_in=t(z[f"s_in_{i}"], np.float32),
                s_w=t(z[f"s_w_{i}"], np.float32), s_out=s_out))
    return layers


def quantize_input(x, s_in) -> torch.Tensor:
    """``clip(round(x / s_in), -128, 127)`` as int8, round half to even.

    ``s_in`` is divided as a tensor on ``x``'s device: CUDA PyTorch turns
    division by a CPU scalar into a multiply by its reciprocal, which is
    not the IEEE quotient and flips the rounding near .5 ties.
    """
    s = torch.as_tensor(s_in, dtype=torch.float32, device=x.device).reshape(1)
    return torch.clamp(torch.round(x / s), -128, 127).to(torch.int8)


def int8_dense(x_q, layer: Int8Layer):
    """One integer layer: int8 x int8 -> int32 accum -> fp32 requant -> int8.

    The oracle's exact sequence (int32 accumulate, fp32 rescale,
    round-half-to-even, clamp).  Integer matrix products run on the CPU
    only, so the oracle takes CPU tensors.
    """
    if x_q.device.type != "cpu":
        raise ValueError("the integer oracle runs on CPU tensors; move the "
                         "layers and features to the CPU first")
    acc = x_q.to(torch.int32) @ layer.w_q.to(torch.int32) + layer.b_q
    if layer.s_out is None:  # linear float head
        return acc.to(torch.float32) * (layer.s_in * layer.s_w)
    requant = (layer.s_in * layer.s_w) / layer.s_out
    y = torch.round(acc.to(torch.float32) * requant)
    y = torch.clamp(y, 0, 127)  # ReLU fused into the clamp (zero-point 0)
    return y.to(torch.int8)


def int_forward(int_layers: Sequence[Int8Layer], x: torch.Tensor) -> torch.Tensor:
    """Full-integer inference from float features (quantize once at entry)."""
    h = quantize_input(x, int_layers[0].s_in)
    for layer in int_layers:
        h = int8_dense(h, layer)
    return h  # float (batch, 2) from the head

"""Dense FFN (counterpart of ``repro.models.mlp``): SwiGLU (llama family) or
squared ReLU (nemotron / minitron), through the shared ``dense``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import dense, normal_init


class MlpParams(NamedTuple):
    w_gate: torch.Tensor | None  # (d, ff); None for the non-gated MLP
    w_in: torch.Tensor           # (d, ff)
    w_out: torch.Tensor          # (ff, d)


def init_mlp(generator, d_model, d_ff, gated=True, device=None) -> MlpParams:
    def normal(shape):
        return normal_init(generator, shape, device=device)

    return MlpParams(w_gate=normal((d_model, d_ff)) if gated else None,
                     w_in=normal((d_model, d_ff)),
                     w_out=normal((d_ff, d_model)))


def mlp_axes(gated=True) -> MlpParams:
    """One layer's logical axes (the reference's without its leading
    stacked-layer ``None``): ff over ``"tp"``, d over ``"fsdp"``."""
    return MlpParams(w_gate=("fsdp", "tp") if gated else None,
                     w_in=("fsdp", "tp"), w_out=("tp", "fsdp"))


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU as ``jax.nn.silu`` lowers it, ``x * (1 / (1 + exp(-x)))``, each
    op rounded to x's dtype: bit for bit the reference's on equal inputs
    (``F.silu`` rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp_block(p: MlpParams, x, *, quant="none"):
    h = dense(x, p.w_in, quant=quant)
    if p.w_gate is not None:
        h = silu(dense(x, p.w_gate, quant=quant)) * h
    else:
        h = torch.square(torch.relu(h))  # squared ReLU (nemotron / minitron)
    return dense(h, p.w_out, quant=quant)

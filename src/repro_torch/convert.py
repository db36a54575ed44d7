"""Numpy -> port conversions: how parameters held by the JAX package (passed
as numpy arrays) become the port's tensors, unchanged in value and layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qat import Int8Layer
from repro_torch.kernels.common import resolve_device
from repro_torch.models.attention import AttentionParams
from repro_torch.models.mlp import MlpParams
from repro_torch.models.moe import MoeParams
from repro_torch.models.ssm import Mamba2Params
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


def _part(tree, name):
    """A field of a NamedTuple or a dict entry (numpy trees keep either)."""
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def lm_params_from_numpy(params, device="cuda") -> dict:
    """The reference's LM params as numpy — ``{"embed", "layers": {"ln1",
    "attn": (wq, wk, wv, wo, bq, bk, bv), "ln2", "mlp": (w_gate, w_in,
    w_out) | "moe": (router (d, E), w_gate, w_in (E, d, ff), w_out (E, ff,
    d), shared: (w_gate, w_in, w_out) | None), "ssm": (wx, wz, wB, wC, wdt,
    dt_bias, A_log, D, conv_x, conv_B, conv_C, gate_norm, wo)},
    "final_norm", "head"}`` with the layer leaves stacked on L (an SSM
    layer has no ``attn``, ``ln2`` or ``mlp``; a VLM's are dense), or the
    encoder-decoder's ``{"enc": {"layers", "norm"}, "dec": {"embed",
    "layers", "norm"}, "head"}`` (a decoder layer adds ``ln_cross`` and
    ``cross``, attention params as ``attn``) — -> the port's params
    (``models.lm``, ``models.encdec``): fp32, same values, same ``(in,
    out)`` layout, one dict per layer."""
    dev = resolve_device(device)

    def t(arr):
        return None if arr is None else torch.from_numpy(
            np.array(arr, np.float32)).to(dev)

    if "enc" in params:
        enc, dec = params["enc"], params["dec"]
        return {"enc": {"layers": _layers_from_numpy(enc["layers"], t),
                        "norm": t(enc["norm"])},
                "dec": {"embed": t(dec["embed"]),
                        "layers": _layers_from_numpy(dec["layers"], t),
                        "norm": t(dec["norm"])},
                "head": t(params["head"])}
    return {
        "embed": t(params["embed"]),
        "layers": _layers_from_numpy(params["layers"], t),
        "final_norm": t(params["final_norm"]),
        "head": t(params["head"]),
    }


def _layers_from_numpy(layers, t) -> list:
    """Layer leaves stacked on L (numpy) -> one dict of tensors (``t``) per
    layer."""
    n_layers = np.asarray(layers["ln1"]).shape[0]

    def at(arr, i):
        return None if arr is None else t(np.asarray(arr)[i])

    def mlp_at(mlp, i):
        return None if mlp is None else MlpParams(
            *(at(_part(mlp, f), i) for f in MlpParams._fields))

    def attn_at(name, i):
        return AttentionParams(*(at(_part(layers[name], f), i)
                                 for f in AttentionParams._fields))

    def layer(i):
        out = {"ln1": at(layers["ln1"], i)}
        if "attn" in layers:
            out["ln2"] = at(layers["ln2"], i)
            out["attn"] = attn_at("attn", i)
        if "cross" in layers:
            out["ln_cross"] = at(layers["ln_cross"], i)
            out["cross"] = attn_at("cross", i)
        if "moe" in layers:
            moe = layers["moe"]
            out["moe"] = MoeParams(
                *(at(_part(moe, f), i) for f in MoeParams._fields[:-1]),
                shared=mlp_at(_part(moe, "shared"), i))
        elif "mlp" in layers:
            out["mlp"] = mlp_at(layers["mlp"], i)
        if "ssm" in layers:
            out["ssm"] = Mamba2Params(*(at(_part(layers["ssm"], f), i)
                                        for f in Mamba2Params._fields))
        return out

    return [layer(i) for i in range(n_layers)]

"""The MRF reconstruction MLPs as model functions for the training engine
(counterpart of ``repro.models.mrf``).

``build_mrf(cfg)`` returns a :class:`ModelFns`: ``init(generator)``, the
float MSE ``loss``, ``predict``, and the QAT pair ``qat_loss(params,
qstate, batch)`` / ``init_qat_aux``.  Batches are ``{"x": (B, 2F), "y":
(B, 2)}`` dicts from ``data.pipeline.batch_at``.  ``ModelFns`` lives in
``models/lm.py``.  The net is tiny (under 30k params), so its params stay
replicated (:func:`mrf_axes`, all ``None``) and a mesh runs it data-parallel:
the batch's features and targets are placed on ``"batch"``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mrf_net, qat
from repro_torch.dist.sharding import shard
from repro_torch.models.lm import ModelFns


def mrf_axes(cfg: ModelConfig) -> list:
    """The params' logical axes: all ``None``, replicated (the reference's
    ``mrf_param_axes``, whose name its dead-exports allowlist holds)."""
    sizes = mrf_net.layer_sizes(cfg.mrf_n_frames, cfg.mrf_hidden)
    return [{"w": (None, None), "b": (None,)} for _ in range(len(sizes) - 1)]


def _placed(batch) -> tuple:
    return (shard(batch["x"], "batch", None), shard(batch["y"], "batch", None))


def mse_loss(params, batch) -> torch.Tensor:
    """The float loss: MSE of the net's (T1, T2) against the targets."""
    return mrf_net.mse_loss(params, *_placed(batch))


def qat_loss(params, qstate, batch):
    """The fake-quantized loss, with the activation observers updated
    functionally (the ``aux_loss`` contract of ``make_train_step``)."""
    x, y = _placed(batch)
    pred, new_qstate = qat.forward_qat(params, qstate, x, train=True)
    return torch.mean(torch.square(pred - y)), new_qstate


def init_qat_aux(params) -> dict:
    return qat.init_qat_state(len(params), device=params[0]["w"].device)


def build_mrf(cfg: ModelConfig) -> ModelFns:
    sizes = mrf_net.layer_sizes(cfg.mrf_n_frames, cfg.mrf_hidden)

    def init(generator: torch.Generator):
        return mrf_net.init_params(generator, sizes)

    def predict(params, batch):
        return mrf_net.forward(params, batch["x"])

    return ModelFns(cfg=cfg, init=init, loss=mse_loss, predict=predict,
                    qat_loss=qat_loss, init_qat_aux=init_qat_aux,
                    param_axes=lambda: mrf_axes(cfg))

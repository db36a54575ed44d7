"""The MRF reconstruction MLPs as model functions for the training engine
(counterpart of ``repro.models.mrf``).

``build_mrf(cfg)`` returns a :class:`ModelFns`: ``init(generator)``, the
float MSE ``loss``, ``predict``, and the QAT pair ``qat_loss(params,
qstate, batch)`` / ``init_qat_aux``.  Batches are ``{"x": (B, 2F), "y":
(B, 2)}`` dicts from ``data.pipeline.batch_at``.  ``ModelFns`` lives in
``models/lm.py``; the net is tiny, so it has no sharding and no param axes.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mrf_net, qat
from repro_torch.models.lm import ModelFns


def mse_loss(params, batch) -> torch.Tensor:
    """The float loss: MSE of the net's (T1, T2) against the targets."""
    return mrf_net.mse_loss(params, batch["x"], batch["y"])


def qat_loss(params, qstate, batch):
    """The fake-quantized loss, with the activation observers updated
    functionally (the ``aux_loss`` contract of ``make_train_step``)."""
    pred, new_qstate = qat.forward_qat(params, qstate, batch["x"], train=True)
    return torch.mean(torch.square(pred - batch["y"])), new_qstate


def init_qat_aux(params) -> dict:
    return qat.init_qat_state(len(params), device=params[0]["w"].device)


def build_mrf(cfg: ModelConfig) -> ModelFns:
    sizes = mrf_net.layer_sizes(cfg.mrf_n_frames, cfg.mrf_hidden)

    def init(generator: torch.Generator):
        return mrf_net.init_params(generator, sizes)

    def predict(params, batch):
        return mrf_net.forward(params, batch["x"])

    return ModelFns(cfg=cfg, init=init, loss=mse_loss, predict=predict,
                    qat_loss=qat_loss, init_qat_aux=init_qat_aux)

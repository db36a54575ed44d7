"""Error metrics of the paper's Table 1 — MAPE, MPE and RMSE on T1/T2 in
ms (counterpart of ``repro.core.metrics``).  The per-metric helpers are
private here: their JAX names are on the dead-exports allowlist."""

from __future__ import annotations

import torch


def _abs_pct_error(pred, true) -> torch.Tensor:
    """Mean absolute percentage error (%)."""
    return 100.0 * torch.mean(torch.abs(pred - true)
                              / torch.clamp_min(torch.abs(true), 1e-9))


def _signed_pct_error(pred, true) -> torch.Tensor:
    """Mean signed percentage error (%): the paper's bias metric."""
    return 100.0 * torch.mean((pred - true)
                              / torch.clamp_min(torch.abs(true), 1e-9))


def _rms_error(pred, true) -> torch.Tensor:
    """Root mean squared error, in the units of the inputs."""
    return torch.sqrt(torch.mean(torch.square(pred - true)))


def table1_metrics(pred_ms, true_ms) -> dict:
    """pred/true: (N, 2) tensors of (T1, T2) in milliseconds."""
    out = {}
    for j, name in enumerate(("T1", "T2")):
        p, t = pred_ms[:, j], true_ms[:, j]
        out[name] = {"MAPE_%": float(_abs_pct_error(p, t)),
                     "MPE_%": float(_signed_pct_error(p, t)),
                     "RMSE_ms": float(_rms_error(p, t))}
    return out


def table1_metrics_normalized(pred_norm, true_norm) -> dict:
    """Table 1 metrics from NORMALISED (T1/T1_max, T2/T2_max) tensors,
    un-normalised by ``data.pipeline.denormalize_targets``."""
    from repro_torch.data.pipeline import denormalize_targets

    return table1_metrics(denormalize_targets(pred_norm),
                          denormalize_targets(true_norm))

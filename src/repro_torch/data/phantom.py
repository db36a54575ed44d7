"""Synthetic 2D brain phantom + simulated MRF acquisition (counterpart of
``repro.data.phantom``).

A concentric-ellipse phantom with CSF / grey / white matter regions at
3T-ish relaxation values, and the per-voxel MRF acquisition (Bloch
simulation + SNR/phase augmentation + feature extraction) that turns it
into a serving request.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.epg import (MRFSequence, augment, simulate_fingerprints,
                                  to_features)
from repro_torch.kernels.common import resolve_device

# tissue classes: (T1 ms, T2 ms) at 3T-ish values
PHANTOM_T1T2_MS = {"background": (0.0, 0.0), "csf": (3500.0, 450.0),
                   "grey": (1400.0, 110.0), "white": (800.0, 80.0)}


def make_phantom(n: int = 32):
    """Concentric-ellipse phantom; returns (t1_map, t2_map, mask), all (n, n)
    numpy arrays.  ``mask`` is True on tissue voxels (the ellipse)."""
    yy, xx = np.mgrid[0:n, 0:n]
    cy = cx = (n - 1) / 2
    r2 = ((yy - cy) / (n * 0.45)) ** 2 + ((xx - cx) / (n * 0.38)) ** 2
    t1 = np.zeros((n, n)); t2 = np.zeros((n, n))
    for name, r_out in (("white", 1.0), ("grey", 0.55), ("csf", 0.18)):
        m = r2 <= r_out
        t1[m], t2[m] = PHANTOM_T1T2_MS[name]
    mask = r2 <= 1.0
    return t1, t2, mask


def acquire_slice(seq: MRFSequence, t1_map, t2_map, mask, *,
                  snr: float = 25.0, generator: torch.Generator | None = None,
                  device="cuda"):
    """Simulate the MRF acquisition of one slice's tissue voxels on
    ``device``.

    Returns ``(features, mask)``: (n_voxels, 2F) fp32 features of the
    masked voxels in row-major order, ready to wrap in a ``ReconRequest``.
    ``generator`` (default: seeded 0) must live on ``device``.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    mask = np.asarray(mask, bool)
    vox = mask.reshape(-1)
    sig = simulate_fingerprints(seq, np.asarray(t1_map).reshape(-1)[vox],
                                np.asarray(t2_map).reshape(-1)[vox],
                                device=dev)
    sig = augment(generator, sig, snr_range=(snr, snr))
    return to_features(sig), mask


def tissue_errors(t1_hat, t2_hat, t1_map, mask) -> dict:
    """Per-tissue mean |error| in % against the phantom's reference values."""
    out = {}
    for name, (ref1, ref2) in PHANTOM_T1T2_MS.items():
        if name == "background":
            continue
        m = (np.asarray(t1_map) == ref1) & np.asarray(mask)
        if not m.any():
            continue
        out[name] = {
            "T1_err_%": float(np.mean(np.abs(t1_hat[m] - ref1)) / ref1 * 100),
            "T2_err_%": float(np.mean(np.abs(t2_hat[m] - ref2)) / ref2 * 100),
        }
    return out

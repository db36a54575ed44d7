"""MRF training-data stream (counterpart of ``repro.data.pipeline``).

Each batch draws (T1, T2) log-uniformly from the physiological prior,
simulates fingerprints with the Bloch recursion and applies the SNR/phase
augmentations, on the device of the ``torch.Generator`` it is given.

The stream is seekable: ``batch_at(stream, seed, step)`` draws the batch of
a global step from a generator seeded by :func:`batch_seed` of the pair, so
the same ``(seed, step)`` gives the same batch on every call.  Restart after
a crash and chunked training (which stages ``n`` steps' batches ahead) rely
on that.  The draws differ from the JAX package's (Philox, not threefry).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.data.epg import (MRFSequence, augment, simulate_fingerprints,
                                  to_features)
from repro_torch.kernels.common import resolve_device

# Physiological brain ranges used by the Barbieri-family MRF papers (ms).
T1_RANGE_MS = (100.0, 4000.0)
T2_RANGE_MS = (10.0, 600.0)


@dataclasses.dataclass(frozen=True)
class MRFSampleStream:
    seq: MRFSequence
    batch_size: int
    snr_range: tuple = (2.0, 50.0)
    t1_range: tuple = T1_RANGE_MS
    t2_range: tuple = T2_RANGE_MS

    @property
    def feature_dim(self) -> int:
        return 2 * self.seq.n_frames


def _log_uniform(generator, n, lo, hi, device):
    u = torch.rand((n,), generator=generator, device=device,
                   dtype=torch.float32)
    return torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)


def sample_batch(stream: MRFSampleStream, generator: torch.Generator):
    """One batch on ``generator``'s device: features (B, 2F) and targets
    (B, 2) in NORMALISED units (T1/T1_max, T2/T2_max)."""
    dev = generator.device
    b = stream.batch_size
    lo1, hi1 = stream.t1_range
    lo2, hi2 = stream.t2_range
    t1 = _log_uniform(generator, b, lo1, hi1, dev)
    t2 = _log_uniform(generator, b, lo2, hi2, dev)
    t2 = torch.minimum(t2, t1)  # T2 <= T1 (physical constraint in tissue)
    sig = simulate_fingerprints(stream.seq, t1, t2, device=dev)
    sig = augment(generator, sig, stream.snr_range)
    return to_features(sig), targets(stream, t1, t2)


def targets(stream: MRFSampleStream, t1, t2) -> torch.Tensor:
    """(B, 2) fp32 targets in NORMALISED units, (T1/T1_max, T2/T2_max), on
    ``t1``'s device."""
    hi1, hi2 = stream.t1_range[1], stream.t2_range[1]
    return torch.stack([t1 / hi1, t2 / hi2], dim=-1).to(torch.float32)


def batch_seed(seed: int, step: int) -> int:
    """The generator seed of the batch at ``step`` of stream ``seed``:
    ``(seed + 1) * 2**32 + step``.  Distinct for every pair with
    ``0 <= step < 2**32``, and never a small seed such as an init seed."""
    if not 0 <= seed < 2 ** 31 or not 0 <= step < 2 ** 32:
        raise ValueError(f"seed {seed} / step {step} outside [0, 2**31) / "
                         f"[0, 2**32)")
    return (seed + 1) * 2 ** 32 + step


def batch_at(stream: MRFSampleStream, seed: int, step: int, *,
             device="cuda") -> dict:
    """The ``{"x", "y"}`` batch of global ``step``, drawn on ``device``."""
    with obs.span("repro_torch.data.batch"):
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(batch_seed(seed, int(step)))
        x, y = sample_batch(stream, gen)
    obs.count("batches")
    return {"x": x, "y": y}


def make_batch_factory(stream: MRFSampleStream, seed: int, *,
                       device="cuda") -> Callable[[int], dict]:
    """Seekable batch factory, the ``ft.runner`` data contract:
    ``factory(step)`` is ``batch_at(stream, seed, step)``."""
    dev = resolve_device(device)

    def at(step: int) -> dict:
        return batch_at(stream, seed, step, device=dev)
    return at


def denormalize_targets(y, t1_range: tuple = T1_RANGE_MS,
                        t2_range: tuple = T2_RANGE_MS) -> torch.Tensor:
    """Normalised (T1/T1_max, T2/T2_max) targets/predictions -> milliseconds.

    The single place that knows how ``sample_batch`` normalised its targets.
    ``y``: (..., 2) tensor; returns float32 of the same shape and device.
    """
    y = torch.as_tensor(y, dtype=torch.float32)
    scale = torch.tensor([t1_range[1], t2_range[1]], dtype=torch.float32,
                         device=y.device)
    return y * scale


def make_eval_set(seq: MRFSequence, n: int = 5000, seed: int = 123,
                  snr: float = 20.0, *, device="cuda"):
    """The paper's held-out evaluation: n never-before-seen synthetic
    signals at a fixed SNR."""
    dev = resolve_device(device)
    stream = MRFSampleStream(seq=seq, batch_size=n, snr_range=(snr, snr))
    return sample_batch(stream, torch.Generator(device=dev).manual_seed(seed))

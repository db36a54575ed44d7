"""MRF signal simulation: IR-bSSFP fingerprint generation in PyTorch
(counterpart of ``repro.data.epg``).

A Bloch-equation recursion over an IR-bSSFP flip-angle train (the Ma et al.
2013 MRF sequence family): the on-resonance isochromat's magnetization
(Mx, My, Mz) is flipped about x with alternating RF sign, relaxed to the
echo at TE = TR/2 (where the complex signal Mx + i My is read) and relaxed
through the rest of the TR.  The JAX package's ``lax.scan`` over frames is
a Python loop here, over batched fp32 tensors (one element per (T1, T2)).

Fingerprints are L2-normalised per signal, then augmented with a random
global phase and complex AWGN at a target SNR — the paper's two
augmentations.  Random draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class MRFSequence:
    """An MRF acquisition schedule: per-frame flip angles (rad) and TRs (s)."""

    flip_angles: tuple  # length n_frames, radians
    trs: tuple          # length n_frames, seconds
    inversion: bool = True
    inv_delay: float = 0.018  # TI after the inversion pulse, seconds

    @property
    def n_frames(self) -> int:
        return len(self.flip_angles)


def default_sequence(n_frames: int = 64, seed: int = 0) -> MRFSequence:
    """A Ma-et-al-style sinusoidal flip-angle train with mildly varying TR."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)
    # Two sinusoidal lobes between ~5 and ~70 degrees, plus small jitter.
    lobes = 10.0 + 60.0 * np.abs(np.sin(np.pi * t / (n_frames / 2.0)))
    fa = np.deg2rad(lobes + rng.uniform(-2.0, 2.0, n_frames))
    # Perlin-ish TR variation around 12 ms.
    tr = 0.012 + 0.003 * np.sin(2 * np.pi * t / max(n_frames, 1)) + rng.uniform(0, 5e-4, n_frames)
    return MRFSequence(flip_angles=tuple(fa.tolist()), trs=tuple(tr.tolist()))


def simulate_fingerprints(seq: MRFSequence, t1_ms, t2_ms, *,
                          device="cuda") -> torch.Tensor:
    """Simulate complex fingerprints for arrays of T1/T2 (in milliseconds).

    Returns a complex64 (batch, n_frames) tensor on ``device``,
    L2-normalised.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    t1_s = torch.as_tensor(t1_ms, dtype=f32, device=dev).reshape(-1) / 1e3
    t2_s = torch.as_tensor(t2_ms, dtype=f32, device=dev).reshape(-1) / 1e3
    r1 = 1.0 / torch.clamp_min(t1_s, 1e-6)
    r2 = 1.0 / torch.clamp_min(t2_s, 1e-6)
    # the sequence's tables from Python tuples: a copy from pageable memory
    with obs.span("repro_torch.data.seq_tables", wait=True):
        fas = torch.as_tensor(seq.flip_angles, dtype=f32, device=dev)
        trs = torch.as_tensor(seq.trs, dtype=f32, device=dev)
    zero = torch.zeros_like(r1)
    mx, my = zero, zero
    if seq.inversion:
        mz = 1.0 + (-1.0 - 1.0) * torch.exp(-seq.inv_delay * r1)
    else:
        mz = torch.ones_like(r1)
    sign = 1.0
    te_frac = 0.5
    re, im = [], []
    for i in range(seq.n_frames):
        a = fas[i] * sign
        ca, sa = torch.cos(a), torch.sin(a)
        # RF rotation about the x-axis by angle a
        my, mz = ca * my + sa * mz, -sa * my + ca * mz
        # relax to TE, read the signal, relax through the rest of the TR
        tr = trs[i]
        e1a = torch.exp(-tr * te_frac * r1)
        e2a = torch.exp(-tr * te_frac * r2)
        mx, my, mz = mx * e2a, my * e2a, 1.0 + (mz - 1.0) * e1a
        re.append(mx)
        im.append(my)
        e1b = torch.exp(-tr * (1.0 - te_frac) * r1)
        e2b = torch.exp(-tr * (1.0 - te_frac) * r2)
        mx, my, mz = mx * e2b, my * e2b, 1.0 + (mz - 1.0) * e1b
        sign = -sign
    sig = torch.complex(torch.stack(re, dim=-1), torch.stack(im, dim=-1))
    norm = torch.linalg.vector_norm(sig, dim=-1, keepdim=True)
    return (sig / torch.clamp_min(norm, 1e-12)).to(torch.complex64)


def augment(generator: torch.Generator, sig: torch.Tensor,
            snr_range=(2.0, 50.0)) -> torch.Tensor:
    """The paper's augmentations: random global phase + AWGN at random SNR.

    Draws on ``generator``, which must live on ``sig``'s device.
    """
    batch, n = sig.shape
    kw = dict(generator=generator, device=sig.device, dtype=torch.float32)
    phase = torch.rand((batch, 1), **kw) * (2 * math.pi)
    sig = sig * torch.exp(torch.complex(torch.zeros_like(phase), phase))
    lo, hi = snr_range
    snr = lo + (hi - lo) * torch.rand((batch, 1), **kw)
    # Per-sample signal power is 1 (L2-normalised over n_frames) -> per-frame
    # power 1/n; noise sigma chosen so per-frame amplitude SNR matches.
    sigma = 1.0 / (snr * math.sqrt(n))
    noise = torch.complex(torch.randn(sig.shape, **kw),
                          torch.randn(sig.shape, **kw)) / math.sqrt(2.0)
    return (sig + sigma * noise).to(torch.complex64)


def to_features(sig: torch.Tensor) -> torch.Tensor:
    """Complex fingerprints -> NN input features [Re | Im], float32."""
    return torch.cat([sig.real, sig.imag], dim=-1).to(torch.float32)

"""The MRF training stream and the nets' initial weights, frozen for the
reference: a copy of what the MRF papers' data stream and He-uniform init
compute, written op for op as the port stages them, so that on the same
device and seeds the reference draws the same batches and weights bit for
bit.  Later changes to the program do not move this file.

A batch of ``n`` samples: (T1, T2) log-uniform over the configuration's
ranges (T2 clipped to T1), an IR-bSSFP fingerprint by the Bloch recursion
over the flip-angle train (Ma et al. 2013 family: RF about x with
alternating sign, relaxation to TE = TR/2 where Mx + i My is read, then
through the rest of the TR), L2-normalised, a random global phase and
complex white noise at an SNR drawn uniformly from the configuration's
range; features [Re | Im], targets (T1 / T1_max, T2 / T2_max).  Every draw
comes from a ``torch.Generator`` on the batch's device seeded with
:func:`batch_seed` of the stream's seed and the step.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Stream:
    flip_angles: tuple   # radians, one a frame
    trs: tuple           # seconds, one a frame
    batch_size: int
    t1_range: tuple      # ms
    t2_range: tuple      # ms
    snr_range: tuple
    inv_delay: float = 0.018  # TI after the inversion pulse, s

    @property
    def n_frames(self) -> int:
        return len(self.flip_angles)


def sequence(n_frames: int, seed: int = 0) -> tuple:
    """(flip angles, TRs) of the sinusoidal two-lobe train: 10-70 degrees
    with +-2 degrees of jitter, TR 12 ms +-3 ms plus up to 0.5 ms."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)
    lobes = 10.0 + 60.0 * np.abs(np.sin(np.pi * t / (n_frames / 2.0)))
    fa = np.deg2rad(lobes + rng.uniform(-2.0, 2.0, n_frames))
    tr = (0.012 + 0.003 * np.sin(2 * np.pi * t / max(n_frames, 1))
          + rng.uniform(0, 5e-4, n_frames))
    return tuple(fa.tolist()), tuple(tr.tolist())


def stream_of(config: dict, batch_size: int) -> Stream:
    """The stream a configuration file states (``stream`` key)."""
    s = config["stream"]
    fa, tr = sequence(config["n_frames"], s["sequence_seed"])
    return Stream(flip_angles=fa, trs=tr, batch_size=batch_size,
                  t1_range=tuple(s["t1_range_ms"]),
                  t2_range=tuple(s["t2_range_ms"]),
                  snr_range=tuple(s["snr_range"]))


def batch_seed(seed: int, step: int) -> int:
    """The generator seed of ``step`` of stream ``seed``."""
    if not 0 <= seed < 2 ** 31 or not 0 <= step < 2 ** 32:
        raise ValueError(f"seed {seed} / step {step} out of range")
    return (seed + 1) * 2 ** 32 + step


def _log_uniform(gen, n, lo, hi, device):
    u = torch.rand((n,), generator=gen, device=device, dtype=torch.float32)
    return torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)


def _fingerprints(st: Stream, t1_ms, t2_ms, device):
    f32 = torch.float32
    t1_s = torch.as_tensor(t1_ms, dtype=f32, device=device).reshape(-1) / 1e3
    t2_s = torch.as_tensor(t2_ms, dtype=f32, device=device).reshape(-1) / 1e3
    r1 = 1.0 / torch.clamp_min(t1_s, 1e-6)
    r2 = 1.0 / torch.clamp_min(t2_s, 1e-6)
    fas = torch.as_tensor(st.flip_angles, dtype=f32, device=device)
    trs = torch.as_tensor(st.trs, dtype=f32, device=device)
    zero = torch.zeros_like(r1)
    mx, my = zero, zero
    mz = 1.0 + (-1.0 - 1.0) * torch.exp(-st.inv_delay * r1)
    sign = 1.0
    re, im = [], []
    for i in range(st.n_frames):
        a = fas[i] * sign
        ca, sa = torch.cos(a), torch.sin(a)
        my, mz = ca * my + sa * mz, -sa * my + ca * mz
        tr = trs[i]
        e1a = torch.exp(-tr * 0.5 * r1)
        e2a = torch.exp(-tr * 0.5 * r2)
        mx, my, mz = mx * e2a, my * e2a, 1.0 + (mz - 1.0) * e1a
        re.append(mx)
        im.append(my)
        e1b = torch.exp(-tr * (1.0 - 0.5) * r1)
        e2b = torch.exp(-tr * (1.0 - 0.5) * r2)
        mx, my, mz = mx * e2b, my * e2b, 1.0 + (mz - 1.0) * e1b
        sign = -sign
    sig = torch.complex(torch.stack(re, dim=-1), torch.stack(im, dim=-1))
    norm = torch.linalg.vector_norm(sig, dim=-1, keepdim=True)
    return (sig / torch.clamp_min(norm, 1e-12)).to(torch.complex64)


def _augment(gen, sig, snr_range):
    batch, n = sig.shape
    kw = dict(generator=gen, device=sig.device, dtype=torch.float32)
    phase = torch.rand((batch, 1), **kw) * (2 * math.pi)
    sig = sig * torch.exp(torch.complex(torch.zeros_like(phase), phase))
    lo, hi = snr_range
    snr = lo + (hi - lo) * torch.rand((batch, 1), **kw)
    sigma = 1.0 / (snr * math.sqrt(n))
    noise = torch.complex(torch.randn(sig.shape, **kw),
                          torch.randn(sig.shape, **kw)) / math.sqrt(2.0)
    return (sig + sigma * noise).to(torch.complex64)


def batch(st: Stream, seed: int, step: int, device) -> tuple:
    """(x (B, 2F), y (B, 2)) float32 of ``step`` of stream ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(batch_seed(seed, int(step)))
    b = st.batch_size
    t1 = _log_uniform(gen, b, *st.t1_range, device)
    t2 = _log_uniform(gen, b, *st.t2_range, device)
    t2 = torch.minimum(t2, t1)
    sig = _augment(gen, _fingerprints(st, t1, t2, device), st.snr_range)
    x = torch.cat([sig.real, sig.imag], dim=-1).to(torch.float32)
    y = torch.stack([t1 / st.t1_range[1], t2 / st.t2_range[1]],
                    dim=-1).to(torch.float32)
    return x, y


def init_params(widths, seed: int, device) -> list:
    """He-uniform weights ``(in, out)`` and zero biases, layer by layer
    from one generator on ``device`` seeded with ``seed``: ``[(w, b)]``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for k, n in zip(widths[:-1], widths[1:]):
        bound = math.sqrt(6.0 / k)
        w = torch.empty((k, n), dtype=torch.float32, device=device)
        w.uniform_(-bound, bound, generator=gen)
        out.append((w, torch.zeros((n,), dtype=torch.float32, device=device)))
    return out

"""Port parity: fingerprint simulation, features, targets and the phantom
against ``repro.data`` on identical inputs.

Deterministic parts compare with JAX: ``simulate_fingerprints`` and
``to_features`` under atol 1e-5 (sin/cos/exp differ by ulps over 32
frames), ``default_sequence``, ``denormalize_targets``, ``make_phantom``
and ``tissue_errors`` exactly.  The random draws of the two frameworks
cannot agree, so the stochastic parts are checked by seeding and by
distribution.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import epg as jepg
from repro.data import phantom as jphantom
from repro.data import pipeline as jpipe
from repro_torch.data import epg as pepg
from repro_torch.data import phantom as pphantom
from repro_torch.data import pipeline as ppipe


def test_default_sequence_is_identical():
    for n in (16, 32, 64):
        assert dataclasses.astuple(pepg.default_sequence(n)) == \
            dataclasses.astuple(jepg.default_sequence(n))


@pytest.mark.parametrize("inversion", [True, False])
def test_simulate_fingerprints_matches_jax(inversion):
    seq = pepg.default_sequence(32)
    if not inversion:
        seq = pepg.MRFSequence(seq.flip_angles, seq.trs, inversion=False)
    rng = np.random.default_rng(0)
    t1 = np.exp(rng.uniform(np.log(100), np.log(4000), 200)).astype(np.float32)
    t2 = np.minimum(np.exp(rng.uniform(np.log(10), np.log(600), 200)),
                    t1).astype(np.float32)
    want = np.asarray(jepg.simulate_fingerprints(
        jepg.MRFSequence(seq.flip_angles, seq.trs, inversion=inversion),
        jnp.asarray(t1), jnp.asarray(t2)))
    got = pepg.simulate_fingerprints(seq, t1, t2, device="cpu")
    assert got.dtype == torch.complex64 and got.shape == (200, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pepg.to_features(got).numpy(),
                               np.asarray(jepg.to_features(jnp.asarray(want))),
                               rtol=0, atol=1e-5)


def test_augment_seeded_and_distributed():
    seq = pepg.default_sequence(32)
    sig = pepg.simulate_fingerprints(seq, np.full(4000, 1400.0),
                                     np.full(4000, 110.0), device="cpu")
    a = pepg.augment(torch.Generator().manual_seed(3), sig, (20.0, 20.0))
    b = pepg.augment(torch.Generator().manual_seed(3), sig, (20.0, 20.0))
    assert torch.equal(a, b) and a.dtype == torch.complex64
    # noise power per frame = 1 / (snr^2 n): residual after removing the
    # per-sample phase projection
    noise = a - sig * (torch.sum(a * sig.conj(), -1, keepdim=True)
                       / torch.sum(sig * sig.conj(), -1, keepdim=True))
    per_frame = float(torch.mean(torch.abs(noise) ** 2)) * 32 / 31
    np.testing.assert_allclose(per_frame, 1 / (20.0 ** 2 * 32), rtol=0.05)
    phase = torch.angle(torch.sum(a * sig.conj(), -1))
    assert float(phase.min()) < -2.5 and float(phase.max()) > 2.5


def test_denormalize_targets_exact():
    y = np.random.default_rng(1).uniform(0, 1, (17, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        ppipe.denormalize_targets(torch.from_numpy(y)).numpy(),
        np.asarray(jpipe.denormalize_targets(jnp.asarray(y))))
    assert ppipe.T1_RANGE_MS == jpipe.T1_RANGE_MS
    assert ppipe.T2_RANGE_MS == jpipe.T2_RANGE_MS


def test_sample_batch_distribution():
    stream = ppipe.MRFSampleStream(seq=pepg.default_sequence(16),
                                   batch_size=2000)
    x, y = ppipe.sample_batch(stream, torch.Generator().manual_seed(0))
    assert x.shape == (2000, stream.feature_dim) and y.shape == (2000, 2)
    t1, t2 = y[:, 0] * 4000.0, y[:, 1] * 600.0
    assert bool(torch.all(t2 <= t1 + 1e-3))
    assert float(t1.min()) >= 100.0 * 0.999 and float(t1.max()) <= 4000.0
    assert float(t2.min()) >= 10.0 * 0.999 and float(t2.max()) <= 600.0
    # log-uniform: the median of log T1 sits mid-range
    mid = (np.log(100.0) + np.log(4000.0)) / 2
    assert abs(float(torch.log(t1).median()) - mid) < 0.2
    x2, y2 = ppipe.sample_batch(stream, torch.Generator().manual_seed(0))
    assert torch.equal(x, x2) and torch.equal(y, y2)
    ex, ey = ppipe.make_eval_set(pepg.default_sequence(16), n=64, device="cpu")
    assert ex.shape == (64, 32) and ey.shape == (64, 2)


@pytest.mark.parametrize("n", [16, 33])
def test_phantom_and_acquisition(n):
    got = pphantom.make_phantom(n)
    want = jphantom.make_phantom(n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    t1, t2, mask = got
    seq = pepg.default_sequence(32)
    f1, m1 = pphantom.acquire_slice(seq, t1, t2, mask, device="cpu",
                                    generator=torch.Generator().manual_seed(5))
    f2, _ = pphantom.acquire_slice(seq, t1, t2, mask, device="cpu",
                                   generator=torch.Generator().manual_seed(5))
    assert torch.equal(f1, f2)
    assert f1.shape == (int(mask.sum()), 64) and f1.dtype == torch.float32
    np.testing.assert_array_equal(m1, mask)
    # noiseless acquisition == the JAX simulator's features, voxel for voxel
    clean = pepg.to_features(pepg.simulate_fingerprints(
        seq, t1[mask], t2[mask], device="cpu"))
    jclean = jepg.to_features(jepg.simulate_fingerprints(
        seq, jnp.asarray(t1[mask]), jnp.asarray(t2[mask])))
    np.testing.assert_allclose(clean.numpy(), np.asarray(jclean), atol=1e-5)


def test_tissue_errors_exact():
    t1, _, mask = pphantom.make_phantom(24)
    rng = np.random.default_rng(2)
    t1_hat = rng.uniform(0, 4000, t1.shape).astype(np.float32)
    t2_hat = rng.uniform(0, 600, t1.shape).astype(np.float32)
    assert pphantom.tissue_errors(t1_hat, t2_hat, t1, mask) == \
        jphantom.tissue_errors(t1_hat, t2_hat, t1, mask)

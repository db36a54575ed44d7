"""Port parity: QAT forward, int8 export, the integer oracle and the ``.npz``
artifact format against ``repro.core.qat`` on identical numpy inputs.

Export and the integer oracle are bit-exact (integer arithmetic and fp32
scales computed op for op); the fake-quantized forward compares under
rtol 1e-5 / atol 1e-6 (fp32 sum order), its observers under rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as jqat
from repro_torch.convert import params_from_numpy
from repro_torch.core import mrf_net as pnet
from repro_torch.core import qat as pqat

HIDDEN = {"mrf-fpga": pnet.ADAPTED_HIDDEN, "mrf-original": pnet.ORIGINAL_HIDDEN}


def _case(arch, seed=0, batch=64):
    sizes = pnet.layer_sizes(32, HIDDEN[arch])
    rng = np.random.default_rng(seed)
    params = [{"w": rng.uniform(-1, 1, (i, o)).astype(np.float32)
               * np.float32(np.sqrt(6.0 / i)),
               "b": rng.normal(0, 0.05, (o,)).astype(np.float32)}
              for i, o in zip(sizes[:-1], sizes[1:])]
    x = rng.normal(size=(batch, sizes[0])).astype(np.float32)
    return params, x


def _jparams(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


def _calibrated_jax(params, x, passes=5):
    qs = jqat.init_qat_state(len(params))
    for _ in range(passes):
        _, qs = jqat.forward_qat(_jparams(params), qs, jnp.asarray(x))
    return qs


@pytest.mark.parametrize("arch", sorted(HIDDEN))
@pytest.mark.parametrize("train", [True, False])
def test_forward_qat_matches_jax(arch, train):
    params, x = _case(arch)
    qs_np = np.asarray(_calibrated_jax(params, x, passes=2)["act_absmax"])
    want, want_qs = jqat.forward_qat(_jparams(params),
                                     {"act_absmax": jnp.asarray(qs_np)},
                                     jnp.asarray(x), train=train)
    got, got_qs = pqat.forward_qat(
        params_from_numpy(params, "cpu"),
        {"act_absmax": torch.from_numpy(qs_np.copy())}, torch.from_numpy(x),
        train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_qs["act_absmax"].numpy(),
                               np.asarray(want_qs["act_absmax"]), rtol=1e-6)


def test_fake_quantize_value_and_straight_through_gradient():
    """Round half to even, clamp to [-128, 127] steps, gradient 1 inside the
    clamp, 0 outside, and one half where the rounded value meets a bound
    exactly — the straight-through estimator of ``jnp.clip``, whose
    gradient splits ties (``torch.clamp`` would pass all of it)."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (200,)).astype(np.float32)
    scale = np.float32(0.02)
    q = np.clip(np.round(x / scale), -128, 127)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pqat.fake_quantize(xt, torch.tensor(scale))
    got.sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(),
                                  (q * scale).astype(np.float32))
    r = np.round(x / scale)
    inside = (r > -128) & (r < 127)
    at_bound = (r == -128) | (r == 127)
    assert inside.any() and at_bound.any() and (~inside & ~at_bound).any()
    np.testing.assert_array_equal(xt.grad.numpy()[inside], 1.0)
    np.testing.assert_array_equal(xt.grad.numpy()[at_bound], 0.5)
    np.testing.assert_array_equal(xt.grad.numpy()[~inside & ~at_bound], 0.0)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    wt = torch.from_numpy(w)
    np.testing.assert_array_equal(
        pqat.weight_scales(wt, pqat.QuantConfig()).numpy(),
        (np.abs(w).max(axis=0, keepdims=True) / np.float32(127)))
    np.testing.assert_array_equal(
        pqat.weight_scales(wt, pqat.QuantConfig(per_channel_weights=False)),
        np.float32(np.abs(w).max() / np.float32(127)))


@pytest.mark.parametrize("arch", sorted(HIDDEN))
def test_qat_loss_gradient_matches_jax(arch):
    """The QAT training gradient against ``jax.grad`` of the same loss.
    Activations above the observer's absmax round onto the clip bound, where
    ``jnp.clip`` passes half the gradient; with ``torch.clamp`` the port's
    gradients differed from the reference by up to 1.6e-2."""
    params, x = _case(arch, seed=7)
    y = np.random.default_rng(8).uniform(0, 1, (x.shape[0], 2)).astype(
        np.float32)
    qs = np.ones((len(params),), np.float32)

    def jloss(p):
        pred, _ = jqat.forward_qat(p, {"act_absmax": jnp.asarray(qs)},
                                   jnp.asarray(x), train=True)
        return jnp.mean(jnp.square(pred - y))

    want = jax.grad(jloss)(_jparams(params))
    pp = [{k: v.requires_grad_(True) for k, v in layer.items()}
          for layer in params_from_numpy(params, "cpu")]
    pred, _ = pqat.forward_qat(pp, {"act_absmax": torch.from_numpy(qs)},
                               torch.from_numpy(x), train=True)
    torch.mean(torch.square(pred - torch.from_numpy(y))).backward()
    for got, w in zip(pp, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k].grad.numpy(), np.asarray(w[k]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", sorted(HIDDEN))
def test_export_int8_bitexact_vs_jax(arch):
    params, x = _case(arch, seed=5)
    qs = _calibrated_jax(params, x)
    want = jqat.export_int8(_jparams(params), qs)
    got = pqat.export_int8(params_from_numpy(params, "cpu"),
                           {"act_absmax": torch.from_numpy(
                               np.asarray(qs["act_absmax"]).copy())})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.w_q.numpy(), np.asarray(w.w_q))
        np.testing.assert_array_equal(g.b_q.numpy(), np.asarray(w.b_q))
        assert g.w_q.dtype == torch.int8 and g.b_q.dtype == torch.int32
        np.testing.assert_array_equal(g.s_in.numpy(), np.asarray(w.s_in))
        np.testing.assert_array_equal(g.s_w.numpy(), np.asarray(w.s_w))
        assert (g.s_out is None) == (w.s_out is None)
        if w.s_out is not None:
            np.testing.assert_array_equal(g.s_out.numpy(), np.asarray(w.s_out))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(pqat.int_forward(got, xt).numpy(),
                                  np.asarray(jqat.int_forward(want,
                                                              jnp.asarray(x))))


def test_artifact_cross_loads_both_ways(tmp_path):
    params, x = _case("mrf-fpga", seed=6)
    jints = jqat.export_int8(_jparams(params), _calibrated_jax(params, x))
    jpath = jqat.save_int8_artifact(tmp_path / "jax", jints)
    pints = pqat.load_int8_artifact(jpath, device="cpu")
    ppath = pqat.save_int8_artifact(tmp_path / "port", pints)
    assert ppath.suffix == ".npz"
    # the same network saves to the same bytes from either package
    assert ppath.read_bytes() == jpath.read_bytes()
    back = jqat.load_int8_artifact(ppath)
    for a, b in zip(back, jints):
        for f in ("w_q", "b_q", "s_in", "s_w"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
            assert np.asarray(getattr(a, f)).dtype == \
                np.asarray(getattr(b, f)).dtype
    np.testing.assert_array_equal(
        pqat.int_forward(pints, torch.from_numpy(x)).numpy(),
        np.asarray(jqat.int_forward(back, jnp.asarray(x))))


def test_oracle_refuses_cuda_style_devices():
    params, x = _case("mrf-fpga")
    ints = pqat.export_int8(params_from_numpy(params, "cpu"),
                            pqat.init_qat_state(len(params), device="cpu"))
    with pytest.raises(ValueError, match="CPU"):
        pqat.int8_dense(torch.zeros((1, 64), dtype=torch.int8,
                                    device="meta"), ints[0])

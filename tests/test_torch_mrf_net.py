"""Port parity: the MRF MLP and its configs against ``repro.core.mrf_net`` /
``repro.configs`` on identical numpy-made parameters.

fp32 outputs compare under rtol 1e-5 / atol 1e-6: the two frameworks sum
the matrix products in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import mrf_net as jnet
from repro_torch import configs as pconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import mrf_net as pnet
from repro_torch.models import registry as pregistry

RTOL, ATOL = 1e-5, 1e-6


def _np_params(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.uniform(-1, 1, (i, o)).astype(np.float32)
             * np.float32(np.sqrt(6.0 / i)),
             "b": rng.normal(0, 0.1, (o,)).astype(np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])]


def _jax(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


@pytest.mark.parametrize("hidden", [pnet.ADAPTED_HIDDEN, pnet.ORIGINAL_HIDDEN])
def test_forward_matches_jax(hidden):
    sizes = pnet.layer_sizes(32, hidden)
    assert sizes == jnet.layer_sizes(32, hidden)
    params = _np_params(sizes)
    x = np.random.default_rng(1).normal(size=(37, sizes[0])).astype(np.float32)
    want, want_hidden = jnet.forward(_jax(params), jnp.asarray(x),
                                     return_hidden=True)
    got, got_hidden = pnet.forward(params_from_numpy(params, "cpu"),
                                   torch.from_numpy(x), return_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    assert len(got_hidden) == len(want_hidden)
    for g, w in zip(got_hidden, want_hidden):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), RTOL, ATOL)


def test_mse_loss_param_count_and_node_match_jax():
    sizes = pnet.layer_sizes(16)
    params = _np_params(sizes, seed=2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(9, sizes[0])).astype(np.float32)
    y = rng.normal(size=(9, 2)).astype(np.float32)
    pp = params_from_numpy(params, "cpu")
    np.testing.assert_allclose(
        float(pnet.mse_loss(pp, torch.from_numpy(x), torch.from_numpy(y))),
        float(jnet.mse_loss(_jax(params), jnp.asarray(x), jnp.asarray(y))),
        RTOL)
    assert pnet.param_count(pp) == jnet.param_count(_jax(params))
    w, b = rng.normal(size=(5,)).astype(np.float32), np.float32(0.3)
    np.testing.assert_allclose(
        float(pnet.node(torch.from_numpy(x[0, :5]), torch.from_numpy(w),
                        torch.tensor(b))),
        float(jnet.node(jnp.asarray(x[0, :5]), jnp.asarray(w), b)), RTOL, ATOL)


def test_init_params_he_uniform_on_generator_device():
    sizes = pnet.layer_sizes(32)
    g = torch.Generator(device="cpu").manual_seed(0)
    params = pnet.init_params(g, sizes)
    assert [tuple(p["w"].shape) for p in params] == list(
        zip(sizes[:-1], sizes[1:]))
    for p, n_in in zip(params, sizes[:-1]):
        bound = np.sqrt(6.0 / n_in)
        assert float(p["w"].abs().max()) <= bound
        assert float(p["w"].abs().max()) > 0.5 * bound
        assert not p["b"].any()
    again = pnet.init_params(torch.Generator(device="cpu").manual_seed(0), sizes)
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(params, again))


@pytest.mark.parametrize("arch", ["mrf-fpga", "mrf-original"])
def test_configs_match_jax(arch):
    for get in ("get_config", "get_smoke"):
        p, j = getattr(pconfigs, get)(arch), getattr(jconfigs, get)(arch)
        assert (p.name, p.family, p.n_layers, p.mrf_n_frames, p.mrf_hidden) \
            == (j.name, j.family, j.n_layers, j.mrf_n_frames, j.mrf_hidden)


def test_lm_arch_names_the_later_slice():
    """Every arch of the reference is in the port now (the encoder-decoder
    and VLM families were the last); an unknown name is refused, and every
    family trains now, the encoder-decoder last (its loss held against the
    reference in tests/test_torch_lm_train_families.py)."""
    assert set(pconfigs.ARCHS) == set(jconfigs.ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        pconfigs.get_config("seamless-m4t-large-v3")
    for arch in pconfigs.ARCHS:
        cfg = pconfigs.get_smoke(arch)
        if cfg.family != "mrf":
            assert callable(pregistry.build(cfg).loss), arch

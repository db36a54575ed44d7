"""Port parity: the functional optimizers, gradient clipping and the Table 1
metrics against ``repro.optim.optimizers`` and ``repro.core.metrics`` on
identical numpy inputs.

Tolerance rtol 1e-5, atol 1e-7: the two packages take the same operations
in the same order, but ``pow`` (Adam's bias correction) and the reductions
may differ by an ulp.  The metrics compare under rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.optim import optimizers as jopt
from repro_torch.convert import params_from_numpy
from repro_torch.core import metrics as pmetrics
from repro_torch.optim import optimizers as popt
from repro_torch.tree import leaves

SHAPES = ((32, 16), (16, 2))
TOL = dict(rtol=1e-5, atol=1e-7)


def _tree(rng, scale=1.0):
    return [{"w": (scale * rng.normal(size=s)).astype(np.float32),
             "b": (scale * rng.normal(size=s[1:])).astype(np.float32)}
            for s in SHAPES]


def _jtree(tree):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in tree]


def _close(got, want, **tol):
    got = [np.asarray(t.detach()) for t in leaves(got)]
    want = [np.asarray(want[i][k]) for i in range(len(want)) for k in ("b", "w")]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **(tol or TOL))


@pytest.mark.parametrize("name,kw", [
    ("adam", dict(lr=1e-3)),
    ("adam", dict(lr=5e-3, weight_decay=1e-2)),
    ("sgd", dict(lr=1e-2)),
    ("sgd", dict(lr=1e-2, momentum=0.9)),
])
def test_optimizer_matches_jax_over_three_updates(name, kw):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(3)]
    jo = getattr(jopt, name)(**kw)
    po = getattr(popt, name)(**kw)
    jp, js = _jtree(params), jo.init(_jtree(params))
    pp = params_from_numpy(params, "cpu")
    ps = po.init(pp)
    for g in grads:
        jp, js = jo.update(_jtree(g), js, jp)
        pp, ps = po.update(params_from_numpy(g, "cpu"), ps, pp)
    _close(pp, jp)
    assert int(ps.step) == int(js.step) == 3
    if name == "adam":
        _close(ps.mu, js.mu)
        _close(ps.nu, js.nu)
    elif kw.get("momentum"):
        _close(ps.momentum, js.momentum)
    else:
        assert ps.momentum is None


def test_updates_mutate_nothing():
    rng = np.random.default_rng(1)
    params = params_from_numpy(_tree(rng), "cpu")
    before = [t.clone() for t in leaves(params)]
    opt = popt.adam(1e-2)
    state = opt.init(params)
    opt.update(params_from_numpy(_tree(rng), "cpu"), state, params)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(params)))
    assert int(state.step) == 0


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clipping_match_jax(max_norm):
    rng = np.random.default_rng(2)
    grads = _tree(rng)
    jg, jn = jopt.clip_by_global_norm(_jtree(grads), max_norm)
    pg, pn = popt.clip_by_global_norm(params_from_numpy(grads, "cpu"),
                                      max_norm)
    np.testing.assert_allclose(float(pn), float(jn), **TOL)
    np.testing.assert_allclose(float(popt.global_norm(
        params_from_numpy(grads, "cpu"))), float(jopt.global_norm(
            _jtree(grads))), **TOL)
    _close(pg, jg)


def test_table1_metrics_normalized_match_jax():
    rng = np.random.default_rng(3)
    true = rng.uniform(0.05, 1.0, (500, 2)).astype(np.float32)
    pred = (true * rng.normal(1.0, 0.1, (500, 2))).astype(np.float32)
    want = jmetrics.table1_metrics_normalized(jnp.asarray(pred),
                                              jnp.asarray(true))
    got = pmetrics.table1_metrics_normalized(torch.from_numpy(pred),
                                             torch.from_numpy(true))
    assert got.keys() == want.keys()
    for tissue in want:
        assert got[tissue].keys() == want[tissue].keys()
        for k in want[tissue]:
            np.testing.assert_allclose(got[tissue][k], want[tissue][k],
                                       rtol=1e-6)

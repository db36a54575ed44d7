"""Port parity: the levers that the dry-run reaches — ``quant="int8-hlo"``
(``models.common.dense_int8``), ``parallel_block`` and
``remat="save_attn"`` (``models.lm``) — against the JAX package on
identical numpy params and batches, and their contracts inside the port.

Tolerances:
* int8-hlo's forward: bit for bit against the reference's eager
  ``_dense_int8_core`` in f32 and bf16 (scales, quantization and the int32
  sums are exact; the rescale rounds once on both sides); its
  straight-through gradient within one bf16 ulp of each result's largest
  magnitude (bf16 products summed in other orders), 1e-6 relative in f32.
* a smoke model's loss and every gradient leaf under ``parallel_block`` or
  ``save_attn``: the LM training tolerances of ``test_torch_lm_train.py``
  (loss rtol 1e-4, 8 bf16 ulps of each leaf's largest); under int8-hlo
  ``QAT_LOSS_RTOL`` and ``QAT_GRAD_ULPS`` of
  ``test_torch_lm_train_families.py`` (a bf16 x / sx one ulp apart puts
  an element on the next int8 level).
* int8-hlo's smoke loss within 10% of the float loss, the reference's
  ``test_int8_hlo_close_to_float``.
* save_attn inside the port: the loss and every gradient bit for bit
  ``"full"``'s, with one more (B, S, d) activation saved a layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch.models import common as pcommon
from repro_torch.models import moe as pmoe
from repro_torch.models import registry as pregistry
from repro_torch.tree import leaves, rebuild
from test_torch_lm_train import (GRAD_ULPS, LOSS_RTOL, _batch, _bf16_ulp,
                                 _grads, _to_port)
from test_torch_lm_train_families import (QAT_GRAD_ULPS, QAT_LOSS_RTOL,
                                          _np, _pair)

ARCHS = ["tinyllama-1.1b", "deepseek-moe-16b"]
LEVERS = {"parallel_block": dict(parallel_block=True),
          "save_attn": dict(remat="save_attn"),
          "parallel_block+int8-hlo": dict(parallel_block=True,
                                          quant="int8-hlo")}
FLIP_SHARE = 0.05  # MoE choices the port may route otherwise (bf16 ties)
SHAPES = [(2, 6, 32, 24),    # 12 rows: padded to 17 for the card's operator
          (3, 7, 20, 13),    # K and N not multiples of 8: padded
          (1, 40, 64, 48)]   # no padding


def _models(arch, **lever):
    from repro.configs import get_smoke as jget_smoke
    from repro.models import registry as jregistry
    from repro_torch.configs import get_smoke
    jcfg = dataclasses.replace(jget_smoke(arch), **lever)
    pcfg = dataclasses.replace(get_smoke(arch), **lever)
    jfns, pfns = jregistry.build(jcfg), pregistry.build(pcfg)
    return jcfg, jfns, jfns.init(jax.random.PRNGKey(0)), pfns


class _RoutingReplay:
    """MoE: the reference's top-k choices recorded from inside its jitted
    loss (an ordered debug callback; its forward's come first), then
    replayed in the port — each layer (found by its router's storage)
    takes the reference's experts with its own probabilities at them,
    renormalised, as gates — so that both compute one function.  The
    port's own choices are counted against the reference's first
    (``flips``): a bf16 near-tie may route one token otherwise, and a
    parallel block or int8 products move the router's input by an ulp."""

    def __init__(self, monkeypatch, params):
        self.jax, self.flips = [], {}
        self.layer_of = {lp["moe"].router.data_ptr(): i
                         for i, lp in enumerate(params["layers"])}
        top_k, route = jax.lax.top_k, pmoe.route

        def recording_top_k(v, k):
            out = top_k(v, k)
            jax.debug.callback(lambda i: self.jax.append(np.asarray(i)),
                               out[1], ordered=True)
            return out

        def replayed(router, xg, top_k, cf):
            r = route(router, xg, top_k, cf)
            layer = self.layer_of[router.data_ptr()]
            want = torch.from_numpy(np.array(self.jax[layer])).long()
            self.flips.setdefault(layer, int((r.idx != want).sum()))
            vals = torch.gather(r.probs, -1, want)
            return r._replace(idx=want,
                              gates=vals / vals.sum(-1, keepdim=True))

        monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
        monkeypatch.setattr(pmoe, "route", replayed)

    def check(self, n_layers: int) -> None:
        for layer in range(n_layers):
            pairs = self.jax[layer].size
            assert self.flips[layer] <= FLIP_SHARE * pairs, \
                f"layer {layer}: {self.flips[layer]} of {pairs} flipped"


# --------------------------------------------------------------------------
# int8-hlo: the dense product
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_int8_dense_forward_matches_the_reference(dtype, shape):
    """``dense(x, w, quant="int8-hlo")`` bit for bit against the eager
    reference (its ``_dense_int8_core`` through ``dense``) over operands
    of many magnitudes, with a bias."""
    b, s, k, n = shape
    rng = np.random.default_rng(k * n)
    for i in range(4):
        x = rng.normal(size=(b, s, k)) * 10.0 ** rng.uniform(-3, 2)
        w = (rng.normal(size=(k, n)) * 10.0 ** rng.uniform(-2, 0)).astype(
            np.float32)
        bias = rng.normal(size=(n,)).astype(np.float32)
        jx, px = _pair(x, dtype)
        want = jcommon.dense(jx, jnp.asarray(w), jnp.asarray(bias),
                             quant="int8-hlo")
        got = pcommon.dense(px, torch.from_numpy(w), torch.from_numpy(bias),
                            quant="int8-hlo")
        assert got.dtype == px.dtype
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=str(i))
        int8_y = pcommon.dense(px, torch.from_numpy(w), quant="int8-hlo")
        float_y = pcommon.dense(px, torch.from_numpy(w))
        assert not torch.equal(int8_y, float_y)  # the int8 products ran


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_straight_through_gradient(dtype):
    """The backward in g's dtype: ``dx = g w^T``, ``dw = x^T g`` over
    every leading dim, as the reference's ``_dense_int8_bwd``."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, 20))
    w = (0.1 * rng.normal(size=(20, 13))).astype(np.float32)
    up = rng.normal(size=(3, 7, 13))
    jx, px = _pair(x, dtype)
    jup, pup = _pair(up, dtype)
    _, vjp = jax.vjp(lambda a, b: jcommon.dense(a, b, quant="int8-hlo"),
                     jx, jnp.asarray(w))
    live = [px.requires_grad_(True), torch.from_numpy(w).requires_grad_(True)]
    got = torch.autograd.grad(pcommon.dense(*live, quant="int8-hlo"), live,
                              pup)
    for what, g, want in zip(("dx", "dw"), got, vjp(jup)):
        assert g.dtype == live[what == "dw"].dtype, what
        err = np.abs(_np(g) - _np(want)).max()
        limit = _bf16_ulp(_np(want)) if dtype == "bfloat16" and \
            what == "dx" else 1e-6 * np.abs(_np(want)).max() \
            if dtype == "float32" else _bf16_ulp(_np(want))
        assert err <= limit, (what, err, limit)


def test_int8_product_pads_exactly():
    """``int8_product`` pads M to 17 and K, N to multiples of 8 with zeros
    for the card's ``_int_mm``: the int32 sums equal an int32 matmul."""
    rng = np.random.default_rng(2)
    for m, k, n in ((1, 5, 3), (16, 8, 8), (17, 9, 15), (33, 64, 40)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
        got = pcommon.int8_product(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got, a.int() @ b.int())


def test_int8_hlo_loss_close_to_float():
    """The smoke tinyllama's loss with int8 products within 10% of the
    float loss on the same params (the reference's
    ``test_int8_hlo_close_to_float``), and within QAT's tolerance of the
    reference's int8-hlo loss."""
    jcfg, jfns, jparams, pfns8 = _models("tinyllama-1.1b", quant="int8-hlo")
    params = _to_port(jparams)
    jb, pb = _batch(jcfg, seed=3)
    pfns = pregistry.build(dataclasses.replace(pfns8.cfg, quant="none"))
    with torch.no_grad():
        loss_f, loss_q = float(pfns.loss(params, pb)), \
            float(pfns8.loss(params, pb))
    assert loss_f != loss_q
    assert abs(loss_f - loss_q) < 0.1 * loss_f
    np.testing.assert_allclose(loss_q, float(jfns.loss(jparams, jb)),
                               rtol=QAT_LOSS_RTOL)


# --------------------------------------------------------------------------
# parallel_block, save_attn: whole models against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lever", list(LEVERS))
@pytest.mark.parametrize("arch", ARCHS)
def test_lever_loss_and_every_grad_leaf_match_jax(arch, lever, monkeypatch):
    """The loss and every gradient leaf of the smoke model with the lever
    against ``jax.value_and_grad`` of the reference's loss with the same
    option (MoE: the reference's routing replayed, :class:`_RoutingReplay`,
    the port's own flips at most ``FLIP_SHARE``); under parallel_block
    ``ln2``'s gradient is zero on both sides."""
    opts = LEVERS[lever]
    jcfg, jfns, jparams, pfns = _models(arch, **opts)
    int8 = opts.get("quant") == "int8-hlo"
    jb, pb = _batch(jcfg, seed=3)
    params = _to_port(jparams)
    replay = _RoutingReplay(monkeypatch, params) \
        if jcfg.family == "moe" else None
    jl, jg = jax.jit(jax.value_and_grad(jfns.loss))(jparams, jb)
    jax.effects_barrier()
    pl, pg = _grads(pfns.loss, params, pb)
    if replay is not None:
        replay.check(jcfg.n_layers)
    np.testing.assert_allclose(float(pl), float(jl),
                               rtol=QAT_LOSS_RTOL if int8 else LOSS_RTOL)
    want = leaves(_to_port(jg))
    assert len(pg) == len(want)
    ulps = QAT_GRAD_ULPS if int8 else GRAD_ULPS
    for i, (got, w) in enumerate(zip(pg, want)):
        assert torch.isfinite(got).all(), i
        err = float((got - w).abs().max())
        assert err <= ulps * _bf16_ulp(w.numpy()), (i, tuple(w.shape), err)
    if opts.get("parallel_block"):
        idx = [i for i in range(len(want)) if _is_ln2(params, i)]
        assert len(idx) == jcfg.n_layers
        assert all(float(pg[i].abs().max()) == 0.0 ==
                   float(want[i].abs().max()) for i in idx)


def _is_ln2(params, index) -> bool:
    """Whether leaf ``index`` of ``params`` is a layer's ``ln2`` gain."""
    marked = rebuild(params, list(range(len(leaves(params)))))
    return any(lp.get("ln2") == index for lp in marked["layers"])


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_save_attn_is_full_bit_for_bit(arch, parallel):
    """``remat="save_attn"`` runs ``"full"``'s ops in two checkpoints a
    block: the loss and every gradient bit for bit, and the backward keeps
    one more (B, S, d) activation a layer (each attention's output; with
    parallel_block its normed input too), counted as distinct storages by
    ``saved_tensors_hooks`` around the forward."""
    from repro_torch.configs import get_smoke
    cfg = dataclasses.replace(get_smoke(arch), parallel_block=parallel)
    params = pregistry.build(cfg).init(0, device="cpu")
    b, s = 2, 32
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).long()
    batch = {"tokens": toks, "labels": toks}

    def run(remat):
        fns = pregistry.build(dataclasses.replace(cfg, remat=remat))
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        saved = set()

        def pack(t):
            if tuple(t.shape) == (b, s, cfg.d_model):
                saved.add(t.untyped_storage()._cdata)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = fns.loss(rebuild(params, live), batch)
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
        return loss.detach(), grads, len(saved)

    loss_f, grads_f, n_full = run("full")
    loss_s, grads_s, n_save = run("save_attn")
    assert torch.equal(loss_f, loss_s)
    assert all(torch.equal(a, c) for a, c in zip(grads_f, grads_s))
    assert n_save - n_full == cfg.n_layers * (2 if parallel else 1)


def test_levers_in_the_families_that_ignore_them():
    """As in the reference: the SSM stack has no attention, so save_attn
    checkpoints whole blocks there (bit for bit "full"); the hybrid and
    SSM blocks ignore parallel_block; the encoder-decoder reads neither."""
    from repro_torch.configs import get_smoke
    for arch in ("mamba2-1.3b", "hymba-1.5b", "seamless-m4t-large-v2"):
        cfg = get_smoke(arch)
        jb, pb = _batch(cfg, seed=5)
        params = pregistry.build(cfg).init(0, device="cpu")
        base = _grads(pregistry.build(cfg).loss, params, pb)
        for lever in (dict(remat="save_attn"), dict(parallel_block=True)):
            got = _grads(pregistry.build(dataclasses.replace(cfg, **lever))
                         .loss, params, pb)
            assert torch.equal(got[0], base[0]), (arch, lever)
            assert all(torch.equal(a, c) for a, c in zip(got[1], base[1]))


def test_parallel_block_changes_the_attention_families():
    """parallel_block changes a dense model's loss (the FFN reads the
    block's input, not ``h + a_out``) and leaves ``ln2`` untouched."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke("tinyllama-1.1b")
    params = pregistry.build(cfg).init(0, device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))).long()
    batch = {"tokens": toks, "labels": toks}
    seq = _grads(pregistry.build(cfg).loss, params, batch)
    par = _grads(pregistry.build(dataclasses.replace(
        cfg, parallel_block=True)).loss, params, batch)
    assert not torch.equal(seq[0], par[0])
    idx = [i for i in range(len(leaves(params))) if _is_ln2(params, i)]
    assert len(idx) == cfg.n_layers
    assert all(float(par[1][i].abs().max()) == 0.0 for i in idx)
    assert all(float(seq[1][i].abs().max()) > 0.0 for i in idx)

"""Port parity: the MoE family (``models/moe``, the MoE branches of
``models/lm``, ``configs``, ``convert.lm_params_from_numpy`` and the token
launcher) against the JAX package on identical numpy inputs.

The reference's routing is read while its ``moe_block`` runs eagerly: its
``lax.top_k`` result and the dense dispatch and combine tensors it hands to
``jnp.einsum`` are recorded (``_jax_moe``).

Tolerances:
* f32: top-k indices, the dispatch mask (within capacity, gate above zero)
  equal; the combine tensor (the renormalised gates) equal up to the
  two softmaxes' f32 rounding, rtol 1e-6 and atol 1e-9 (a gate of ~6e-7
  differs by ~1e-12); ``y`` within atol 1e-5 (sum order of the two
  frameworks' f32 products); ``aux`` within 1e-6.
* bf16 activations: routing equal (the router runs in f32 on the same
  bf16 values), the combine in bf16 within one rounding, ``y`` within 2
  bf16 ulps of its largest magnitude.
* the model (smoke configs, prefill and 4 decode steps): routing first —
  the two frameworks' bf16 activations differ by an ulp here and there, so
  a near-tie in a router can pick another expert: the flipped (token,
  choice) pairs are counted per layer and fail above ``MAX_FLIP_SHARE``;
  logits and caches are held at the dense family's tolerance
  (``test_torch_lm.SLICE_ULPS``) on every request whose tokens were
  routed and dispatched alike in every layer so far.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import moe as jmoe
from repro.models.common import key_iter
from repro_torch import configs as pconfigs
from repro_torch.configs import base as pbase
from repro_torch.kernels.flash_attn.kernel import flash_attention_call
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import moe as pmoe
from repro_torch.models import registry as pregistry
from repro_torch.models.mlp import MlpParams
from repro_torch.tree import leaves
from test_torch_lm import (_greedy_agrees, _models, _np, _run, _slice_close,
                           bf16_ulp)

MOE = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"]


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_match_jax(arch):
    fields = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size", "head_dim", "n_experts",
              "n_shared_experts", "top_k", "capacity_factor", "gated_mlp",
              "rope_theta", "norm_eps")
    for get, jget in ((pconfigs.get_config, jget_config),
                      (pconfigs.get_smoke, jget_smoke)):
        p, j = get(arch), jget(arch)
        assert [getattr(p, f) for f in fields] == \
            [getattr(j, f) for f in fields]
        assert pbase.param_count(p) == jbase.param_count(j)
        assert pbase.active_param_count(p) == jbase.active_param_count(j)
    want = {"deepseek-moe-16b": (16_879_568_896, 2_830_747_648),
            "phi3.5-moe-42b-a6.6b": (41_872_527_360, 6_640_373_760)}[arch]
    cfg = pconfigs.get_config(arch)
    assert (pbase.param_count(cfg), pbase.active_param_count(cfg)) == want
    with pytest.raises(ValueError, match="experts"):
        dataclasses.replace(cfg, top_k=0).validate()


# --------------------------------------------------------------------------
# moe_block against the reference
# --------------------------------------------------------------------------

def _params(seed, d, ff, n_exp, n_shared, *, skew=0.0):
    """The reference's init (scaled up so the routing is decided), as JAX
    params and the port's.  ``skew`` adds a large router column 0 along
    the all-ones direction: with inputs of a positive mean every token
    then picks expert 0 first, and the group overflows its capacity."""
    jp = jmoe.init_moe(key_iter(jax.random.PRNGKey(seed)), d, ff, n_exp,
                       n_shared)
    jp = jax.tree.map(lambda a: 10.0 * a, jp)
    if skew:
        jp = jp._replace(router=jp.router.at[:, 0].add(skew))
    shared = None if jp.shared is None else MlpParams(
        *(torch.from_numpy(np.array(a)) for a in jp.shared))
    pp = pmoe.MoeParams(*(torch.from_numpy(np.array(a)) for a in jp[:4]),
                        shared=shared)
    return jp, pp


def _jax_moe(monkeypatch, jp, x, **kw):
    """The reference's moe_block on x, and its routing: (y, aux, idx,
    dispatch, combine) as numpy."""
    seen = {}
    top_k = jax.lax.top_k

    def recording_top_k(v, k):
        seen["top_k"] = top_k(v, k)
        return seen["top_k"]

    class Recorder:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def einsum(spec, *ops, **ekw):
            seen[spec] = ops
            return jnp.einsum(spec, *ops, **ekw)

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    monkeypatch.setattr(jmoe, "jnp", Recorder())
    y, aux = jmoe.moe_block(jp, x, **kw)
    monkeypatch.undo()
    return (_np(y), float(aux), np.asarray(seen["top_k"][1]),
            _np(seen["gsec,gsd->gecd"][0]), _np(seen["gsec,gecd->gsd"][0]))


def _dense_keep(slot, keep, idx, n_exp, cap):
    """The index form's (slot, keep) as a dense (G, s, E, C) mask."""
    g, s, k = idx.shape
    out = np.zeros((g, s, n_exp, cap), bool)
    gi, si, ji = np.nonzero(keep.numpy())
    out[gi, si, idx.numpy()[gi, si, ji], slot.numpy()[gi, si, ji]] = True
    return out


CASES = {  # label: (B, S, d, ff, E, n_shared, top_k, group, skew, dtype)
    "no shared experts": (2, 32, 16, 32, 4, 0, 2, 16, 0.0, "float32"),
    "shared experts": (2, 32, 16, 32, 4, 1, 2, 16, 0.0, "float32"),
    "fine-grained, top-6 of 16": (1, 64, 16, 8, 16, 2, 6, 32, 0.0,
                                  "float32"),
    "biased router, drops": (2, 32, 16, 32, 4, 1, 2, 16, 3.0, "float32"),
    "bf16, drops": (2, 32, 16, 32, 4, 1, 2, 16, 3.0, "bfloat16"),
    "decode shape (B, 1, d), drops": (8, 1, 16, 32, 4, 0, 2, 256, 3.0,
                                      "float32"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_jax(case, monkeypatch):
    b, s, d, ff, n_exp, n_sh, k, gs, skew, dtype = CASES[case]
    jp, pp = _params(len(case), d, ff, n_exp, n_sh, skew=skew)
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=(b, s, d)) + (0.5 if skew else 0.0)
    jx = jnp.asarray(x).astype(dtype)
    px = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    kw = dict(top_k=k, capacity_factor=1.25, group_size=gs)
    jy, jaux, jidx, jdispatch, jcombine = _jax_moe(monkeypatch, jp, jx, **kw)

    xg = pmoe._groups(px, gs)
    r = pmoe.route(pp.router, xg, k, 1.25)
    np.testing.assert_array_equal(r.idx.numpy(), jidx)
    combine = pmoe.dense_combine(r, n_exp)
    np.testing.assert_array_equal(combine.numpy() > 0, jdispatch > 0)
    if dtype == "float32":
        np.testing.assert_allclose(combine.numpy(), jcombine,
                                   rtol=1e-6, atol=1e-9)
    else:  # the reference hands its combine on in bf16: one rounding apart
        np.testing.assert_allclose(_np(combine.to(px.dtype)), jcombine,
                                   rtol=2.0 ** -8, atol=0)
    slot, keep = pmoe.slots(r, n_exp)
    np.testing.assert_array_equal(
        _dense_keep(slot, keep, r.idx, n_exp, r.capacity), jdispatch > 0)
    if skew:  # the case is there to drop tokens: it must
        assert not keep.all()

    for fn in (pmoe.moe_block, pmoe.moe_block_plain):
        y, aux = fn(pp, px, **kw)
        assert y.dtype == px.dtype and y.shape == px.shape
        if dtype == "float32":
            np.testing.assert_allclose(_np(y), jy, rtol=0, atol=1e-5)
        else:
            assert np.abs(_np(y) - jy).max() <= 2 * bf16_ulp(jy)
        assert abs(float(aux) - jaux) <= 1e-6


def test_index_dispatch_equals_the_dense_one_hot():
    """The model's index-based dispatch against the plain dense one-hot
    form, on many random routings with drops: the same kept (token, choice)
    slots, the same expert inputs, outputs equal up to the combine's sum
    order."""
    for seed in range(12):
        rng = np.random.default_rng(seed)
        n_exp, k = int(rng.choice([4, 8, 16])), int(rng.integers(1, 4))
        _, pp = _params(seed, 16, 24, n_exp, seed % 2,
                        skew=float(rng.choice([0.0, 2.0])))
        x = torch.from_numpy(rng.normal(size=(4, 16, 16)) + 0.3).float()
        xg = pmoe._groups(x, 16)
        r = pmoe.route(pp.router, xg, k, 1.0)
        slot, keep = pmoe.slots(r, n_exp)
        dense = pmoe.dense_combine(r, n_exp)
        np.testing.assert_array_equal(
            _dense_keep(slot, keep, r.idx, n_exp, r.capacity),
            dense.numpy() > 0)
        got, aux = pmoe.moe_block(pp, x, top_k=k, capacity_factor=1.0,
                                  group_size=16)
        want, aux_p = pmoe.moe_block_plain(pp, x, top_k=k,
                                           capacity_factor=1.0,
                                           group_size=16)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert float(aux) == float(aux_p)


def test_ties_go_to_the_lower_expert():
    """``lax.top_k`` keeps the lower index first among equal values: so
    does the port's stable sort."""
    router = torch.zeros((4, 6))
    r = pmoe.route(router, torch.ones((1, 8, 4)), 3, 1.25)
    assert r.idx[0, 0].tolist() == [0, 1, 2]
    j = jax.lax.top_k(jax.nn.softmax(jnp.zeros((6,))), 3)[1]
    assert np.asarray(j).tolist() == [0, 1, 2]


def test_a_group_that_does_not_divide_is_refused():
    jp, pp = _params(0, 16, 32, 4, 0)
    x = np.random.default_rng(0).normal(size=(3, 100, 16)).astype(np.float32)
    with pytest.raises(AssertionError):
        jmoe.moe_block(jp, jnp.asarray(x), top_k=2)
    for fn in (pmoe.moe_block, pmoe.moe_block_plain):
        with pytest.raises(ValueError, match="routing groups of 256"):
            fn(pp, torch.from_numpy(x), top_k=2)
    assert pmoe.group_of(8) == 8 and pmoe.group_of(512) == 256


def test_capacity():
    """The capacities of the two served archs at their served groups."""
    assert pmoe.capacity_of(256, 6, 1.25, 64) == 30   # deepseek prefill
    assert pmoe.capacity_of(8, 6, 1.25, 64) == 4      # deepseek decode
    assert pmoe.capacity_of(256, 2, 1.25, 16) == 40   # phi3.5 prefill
    assert pmoe.capacity_of(8, 2, 1.25, 16) == 4      # phi3.5 decode


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

MAX_FLIP_SHARE = 0.05  # of a layer's (token, choice) pairs, model vs JAX


class _Routings:
    """Each MoE call's routing on both sides, in call order: the experts
    chosen (G, s, k) and the experts each token is dispatched to (G, s, E;
    its slot there may differ: a flip moves later tokens' slots).  The
    reference's are read by ordered debug callbacks from inside its jitted
    functions, the port's by wrapping ``slots``."""

    def __init__(self, monkeypatch):
        self.jax_idx, self.jax_dispatch, self.port = [], [], []
        top_k = jax.lax.top_k

        def recording_top_k(v, k):
            out = top_k(v, k)
            jax.debug.callback(
                lambda i: self.jax_idx.append(np.asarray(i)), out[1],
                ordered=True)
            return out

        class Recorder:
            def __getattr__(self, name):
                return getattr(jnp, name)

            @staticmethod
            def einsum(spec, *ops, **kw):
                if spec == "gsec,gsd->gecd":
                    jax.debug.callback(
                        lambda d: jax_dispatch.append(
                            (np.asarray(d) > 0).any(-1)),
                        ops[0], ordered=True)
                return jnp.einsum(spec, *ops, **kw)

        jax_dispatch = self.jax_dispatch
        slots = pmoe.slots

        def recording_slots(r, n_exp):
            slot, keep = slots(r, n_exp)
            self.port.append((r.idx, _dense_keep(
                slot, keep, r.idx, n_exp, r.capacity).any(-1)))
            return slot, keep

        monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
        monkeypatch.setattr(jmoe, "jnp", Recorder())
        monkeypatch.setattr(pmoe, "slots", recording_slots)

    def same_rows(self, n_rows: int, what: str) -> np.ndarray:
        """Consume the calls recorded so far (one a layer): per request
        (tokens are (B*S) rows in order), whether every token of it was
        routed and dispatched alike in every layer.  Fails above
        ``MAX_FLIP_SHARE`` flipped (token, choice) pairs in a layer."""
        jax.effects_barrier()
        calls = list(zip(self.jax_idx, self.jax_dispatch, self.port))
        assert calls and len(self.jax_idx) == len(self.port)
        same = np.ones(n_rows, bool)
        for layer, (j_idx, j_disp, (p_idx, p_disp)) in enumerate(calls):
            flipped = j_idx != p_idx.numpy()
            share = flipped.mean()
            assert share <= MAX_FLIP_SHARE, \
                f"{what}, layer {layer}: {share:.3f} of the choices flipped"
            alike = ~flipped.any(-1) & (j_disp == p_disp).all(-1)
            same &= alike.reshape(n_rows, -1).all(-1)
        self.jax_idx.clear(), self.jax_dispatch.clear(), self.port.clear()
        return same


def _rows_close(got, want, rows, what, axis=0):
    """``_slice_close`` on the requests ``rows`` (along ``axis``)."""
    idx = np.nonzero(rows)[0]
    return _slice_close(np.take(_np(got), idx, axis),
                        np.take(_np(want), idx, axis), what)


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_and_four_decode_steps_match_jax(arch, monkeypatch):
    jcfg, jfns, jparams, pfns, params = _models(arch)
    assert "moe" in params["layers"][0] and "mlp" not in params["layers"][0]
    routing = _Routings(monkeypatch)
    rng = np.random.default_rng(8)
    b, s = 4, 24
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jcache, jlogits = jfns.prefill(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        cache, logits = pfns.prefill(params, {"tokens": torch.from_numpy(toks)})
    same = routing.same_rows(b, "prefill")
    assert same.sum() >= b // 2, f"prefill: requests routed alike {same}"
    tol = _rows_close(logits, jlogits, same, "prefill logits")
    _greedy_agrees(_np(logits)[same], _np(jlogits)[same], tol)
    for name in ("k", "v"):
        _rows_close(cache[name], jcache[name], same,
                    f"prefill cache {name}", axis=1)
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for i in range(4):
        jlogits, jcache = jfns.decode(jparams, jcache, jnp.asarray(tok),
                                      jnp.int32(s + i))
        with torch.no_grad():
            logits, cache = pfns.decode(params, cache, torch.from_numpy(tok),
                                        s + i)
        same &= routing.same_rows(b, f"decode step {i}")
        assert same.sum() >= b // 2, f"step {i}: routed alike {same}"
        tol = _rows_close(logits, jlogits, same, f"decode step {i} logits")
        _greedy_agrees(_np(logits)[same], _np(jlogits)[same], tol)
        for name in ("k", "v"):
            _rows_close(cache[name], jcache[name], same,
                        f"step {i} cache {name}", axis=1)
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


def test_moe_compute_copy_keeps_the_router_in_f32():
    """bf16 params made at init: every param cast once except the routers,
    which route in f32 as the masters do; same logits as the masters."""
    cfg = pconfigs.get_smoke("deepseek-moe-16b")
    fns = pregistry.build(cfg)
    masters = fns.init(3, device="cpu")
    copy = fns.init(3, device="cpu", dtype=torch.bfloat16)
    for lc, lm in zip(copy["layers"], masters["layers"]):
        assert lc["moe"].router.dtype == torch.float32
        assert torch.equal(lc["moe"].router, lm["moe"].router)
        lc = {**lc, "moe": lc["moe"]._replace(router=None)}
        assert all(t.dtype == torch.bfloat16 for t in leaves(lc))
    toks = {"tokens": torch.arange(16, dtype=torch.int32)[None] * 7}
    with torch.no_grad():
        assert torch.equal(fns.prefill(masters, toks)[1],
                           fns.prefill(copy, toks)[1])


def test_moe_token_launcher_on_the_cpu():
    argv = ["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
            "--requests", "2", "--prompt-len", "32", "--gen-len", "4"]
    before = flash_attention_call.launches
    reports = []
    for _ in range(2):
        rc, out = _run(argv)
        assert rc == 0
        last = out.splitlines()[-1]
        assert last.startswith("token_report ")
        reports.append(json.loads(last.split(" ", 1)[1]))
    rep = reports[0]
    assert (rep["arch"], rep["requests"], rep["prompt"]) == \
        ("deepseek-moe-16b-smoke", 2, 32)
    assert np.array(rep["tokens"]).shape == (2, 4)
    assert rep["tokens"] == reports[1]["tokens"]
    assert rep["flash_attn_launches"] == 0
    assert flash_attention_call.launches == before
    # 2 x 200 tokens are not a whole number of groups of 256: refused
    # before any weight is made
    with pytest.raises(ValueError, match="routing groups of 256"):
        serve_launcher.main([*argv[:-6], "--requests", "2",
                             "--prompt-len", "200", "--gen-len", "4"])

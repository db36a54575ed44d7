"""Port parity: training of the MoE, SSM, hybrid and encoder-decoder LM
families, and the paper's int8 QAT on the LMs (``quant="qat-int8"``:
``models.common.fake_quantize_int8`` in every dense projection), against
``jax.value_and_grad`` of the reference on identical numpy params and
batches; the port's own contracts (remat changes no bit, crash + restart
through the launcher equals an uninterrupted run bit for bit, the
refusals that remain).

Tolerances (those of ``tests/test_torch_lm_train.py`` unless said):
* ``fake_quantize_int8`` against the reference's ``fake_quant_int8``,
  both eager, in f32 and bf16: the values and the straight-through
  gradient bit for bit.
* ``dense(quant="qat-int8")``: f32 within rtol 1e-6 of the output's
  largest magnitude (the two frameworks' f32 products sum in other
  orders), bf16 within one bf16 ulp of it; the gradients the same way.
* The MoE block in f32 against ``jax.grad`` of the reference's
  ``moe_block``: the routing (top-k experts, dispatch) equal first, then
  ``y``, ``aux`` and every gradient leaf within 1e-5 of the leaf's largest
  magnitude.
* Whole smoke models: the loss within ``LOSS_RTOL`` and every gradient
  leaf within ``GRAD_ULPS`` bf16 ulps of its largest magnitude.  For the
  MoE family the routing is compared first: the port's and the
  reference's top-k experts in every layer of the forward must be equal
  (a flip fails the test with its count; the gradients of a flipped
  token are another function's).  The batches' seeds: 3 for the models,
  10-12 for the Adam steps, and 4 for deepseek under QAT
  (``QAT_MOE_SEED``): there seed 3 flips 2 of layer 0's 128 choices, a
  near-tie that fake-quant's scale and rounding magnify from an ulp of
  the attention's output (eager JAX flips the same 2); of seeds 4-11, 4
  of 8 flip a choice under QAT.
* Under QAT the loss within ``QAT_LOSS_RTOL`` = 3e-4 and each gradient
  leaf within ``QAT_GRAD_ULPS`` = 16 bf16 ulps: fake-quant's per-tensor
  scale follows an activation's largest magnitude and its rounding moves
  a value by a whole int8 level, so an ulp's difference upstream becomes
  a level's.  The reference is no closer to itself: its eager and jitted
  gradients of the mamba2 smoke model under QAT differ by 9.6 such ulps
  and its losses by 1.35e-4 (the port's mixer equals the eager one bit
  for bit, with and without QAT); the port reads up to 12 ulps and
  1.35e-4 against the jitted reference.
* 3 Adam steps with clipping: as in ``test_torch_lm_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models.common import key_iter
from repro.optim import optimizers as jopt
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs as pconfigs
from repro_torch.launch import train as train_launcher
from repro_torch.models import common as pcommon
from repro_torch.models import encdec as pencdec
from repro_torch.models import lm as plm
from repro_torch.models import moe as pmoe
from repro_torch.models import registry as pregistry
from repro_torch.models import ssm as pssm
from repro_torch.models.mlp import MlpParams
from repro_torch.optim import adam
from repro_torch.tree import leaves
from repro_torch.train.step import init_train_state, make_train_step
from test_torch_lm_train import (GRAD_ULPS, LOSS_RTOL, _batch, _bf16_ulp,
                                 _grads, _launch, _models, _to_port)

FAMILIES = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
            "hymba-1.5b", "seamless-m4t-large-v2"]
QAT = ["tinyllama-1.1b", "deepseek-moe-16b", "mamba2-1.3b",
       "seamless-m4t-large-v2"]
#: the batch seed of the QAT MoE model's case (module docstring)
QAT_MOE_SEED = 4
QAT_LOSS_RTOL = 3e-4
QAT_GRAD_ULPS = 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(arr, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``,
    rounded once for both."""
    j = jnp.asarray(arr).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


# --------------------------------------------------------------------------
# fake-quant and the QAT projection
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quantize_int8_matches_the_reference(dtype):
    """Values and the straight-through gradient bit for bit, eager on both
    sides, over tensors of many magnitudes (bf16: the scale, the division
    and ``x + (q - x)`` each round, so the value is not ``q``)."""
    rng = np.random.default_rng(0)
    upstream = rng.normal(size=(24, 40)).astype(np.float32)
    for i in range(12):
        x = rng.normal(size=(24, 40)) * 10.0 ** rng.uniform(-3, 2)
        jx, px = _pair(x, dtype)
        jg_up, pg_up = _pair(upstream, dtype)
        want, vjp = jax.vjp(jcommon.fake_quant_int8, jx)
        px.requires_grad_(True)
        got = pcommon.fake_quantize_int8(px)
        (pg,) = torch.autograd.grad(got, px, pg_up)
        assert got.dtype == px.dtype
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=str(i))
        np.testing.assert_array_equal(_np(pg), _np(vjp(jg_up)[0]))
        if dtype == "float32":  # on the levels: at most 127 of them
            s = float(np.abs(_np(px)).max()) / 127.0 + 1e-12
            assert np.abs(np.round(_np(got) / s)).max() <= 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qat_dense_matches_the_reference(dtype):
    """``dense(x, w, b, quant="qat-int8")``: x in ``dtype``, w and b the
    f32 masters, fake-quantized before w's cast, as the reference's; the
    output and the gradients of x, w and b."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 32))
    w = (0.1 * rng.normal(size=(32, 24))).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    up = rng.normal(size=(2, 6, 24))
    jx, px = _pair(x, dtype)
    jup, pup = _pair(up, dtype)

    def jf(xx, ww, bb):
        return jcommon.dense(xx, ww, bb, quant="qat-int8")

    want, vjp = jax.vjp(jf, jx, jnp.asarray(w), jnp.asarray(b))
    live = [px.requires_grad_(True), torch.from_numpy(w).requires_grad_(True),
            torch.from_numpy(b).requires_grad_(True)]
    got = pcommon.dense(*live, quant="qat-int8")
    grads = torch.autograd.grad(got, live, pup)
    for what, g, wv in (("y", got, want), *zip(("dx", "dw", "db"), grads,
                                                 vjp(jup))):
        err = np.abs(_np(g) - _np(wv)).max()
        top = np.abs(_np(wv)).max()
        limit = 1e-6 * top if dtype == "float32" and what != "dx" else \
            _bf16_ulp(_np(wv)) if dtype == "bfloat16" else 1e-6 * top
        assert err <= limit, (what, err, limit)
    # the deployment form the reference's dry-run reaches: its own values
    # (held op for op in ``test_torch_perf_levers.py``)
    np.testing.assert_array_equal(
        _np(pcommon.dense(px.detach(), torch.from_numpy(w), quant="int8-hlo")),
        _np(jcommon.dense(jx, jnp.asarray(w), quant="int8-hlo")))


# --------------------------------------------------------------------------
# the MoE block's gradient
# --------------------------------------------------------------------------

MOE_CASES = {  # label: (B, S, d, ff, E, n_shared, top_k, group, skew)
    "shared experts": (2, 32, 16, 32, 4, 1, 2, 16, 0.0),
    "no shared experts, drops": (2, 32, 16, 32, 4, 0, 2, 16, 3.0),
    "top-6 of 16, two shared": (1, 64, 16, 8, 16, 2, 6, 32, 0.0),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("quant", ["none", "qat-int8"])
def test_moe_block_gradients_match_jax(case, quant, monkeypatch):
    """f32: the port's expert-major dispatch under grad against
    ``jax.grad`` of the reference's dense one-hot ``moe_block`` — the
    routing first (top-k experts equal), then ``y``, ``aux`` and the
    gradients of x, the router (through the softmax and the renormalised
    top-k gates, and ``aux``), the three expert weights and the shared
    experts (``quant`` reaches only them, as in the reference)."""
    b, s, d, ff, n_exp, n_sh, k, gs, skew = MOE_CASES[case]
    jp = jmoe.init_moe(key_iter(jax.random.PRNGKey(len(case))), d, ff,
                       n_exp, n_sh)
    jp = jax.tree.map(lambda a: 10.0 * a, jp)
    if skew:
        jp = jp._replace(router=jp.router.at[:, 0].add(skew))
    rng = np.random.default_rng(len(case))
    x = (rng.normal(size=(b, s, d)) + (0.5 if skew else 0.0)).astype(
        np.float32)
    up = rng.normal(size=(b, s, d)).astype(np.float32)
    kw = dict(top_k=k, capacity_factor=1.25, group_size=gs, quant=quant)

    seen = {}
    top_k = jax.lax.top_k

    def recording_top_k(v, kk):
        seen["idx"] = top_k(v, kk)[1]
        return top_k(v, kk)

    def jloss(params, xx):
        y, aux = jmoe.moe_block(params, xx, **kw)
        return jnp.sum(y * jnp.asarray(up)) + 3.0 * aux, (y, aux)

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    monkeypatch.undo()

    def port(a):
        return torch.from_numpy(np.array(a)).requires_grad_(True)

    shared = None if jp.shared is None else MlpParams(
        *(port(a) for a in jp.shared))
    pp = pmoe.MoeParams(*(port(a) for a in jp[:4]), shared=shared)
    px = port(x)
    xg = pmoe._groups(px, gs)
    r = pmoe.route(pp.router, xg, k, 1.25)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(seen["idx"]))
    if skew:
        assert not pmoe.slots(r, n_exp)[1].all()  # the case drops tokens
    y, aux = pmoe.moe_block(pp, px, **kw)
    loss = torch.sum(y * torch.from_numpy(up)) + 3.0 * aux
    live = leaves(pp) + [px]
    got = torch.autograd.grad(loss, live)
    want = [np.asarray(a) for a in jax.tree.leaves(jgp)] + [np.asarray(jgx)]
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=0, atol=1e-5)
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-6
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        err = float(np.abs(_np(g) - w).max())
        assert err <= 1e-5 * max(float(np.abs(w).max()), 1e-3), (i, err)


# --------------------------------------------------------------------------
# whole models: loss and every gradient leaf
# --------------------------------------------------------------------------

class _TopK:
    """The experts each MoE layer chose, on both sides, in call order: the
    reference's read by an ordered debug callback from inside its jitted
    loss (forward and remat recompute both call it), the port's by wrapping
    ``moe.route``."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        top_k, route = jax.lax.top_k, pmoe.route

        def recording_top_k(v, k):
            out = top_k(v, k)
            jax.debug.callback(lambda i: self.jax.append(np.asarray(i)),
                               out[1], ordered=True)
            return out

        def recording_route(*a, **kw):
            r = route(*a, **kw)
            self.port.append(r.idx.numpy().copy())
            return r

        monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
        monkeypatch.setattr(pmoe, "route", recording_route)

    def check(self, n_layers: int) -> None:
        """The forward's n_layers routings (the first of each side's calls;
        the recompute repeats them) are equal; a flip fails with its
        count."""
        jax.effects_barrier()
        assert len(self.jax) >= n_layers and len(self.port) >= n_layers
        for layer, (j, p) in enumerate(zip(self.jax[:n_layers],
                                           self.port[:n_layers])):
            flips = int((j != p).sum())
            assert flips == 0, \
                f"layer {layer}: {flips} of {j.size} top-k choices flipped"


def _loss_and_grads_match(arch, quant, monkeypatch):
    jcfg, jfns, jparams, pfns = _models(arch, quant)
    seed = QAT_MOE_SEED if quant != "none" and jcfg.family == "moe" else 3
    jb, pb = _batch(jcfg, seed=seed)
    topk = _TopK(monkeypatch) if jcfg.family == "moe" else None
    jl, jg = jax.jit(jax.value_and_grad(jfns.loss))(jparams, jb)
    pl, pg = _grads(pfns.loss, _to_port(jparams), pb)
    if topk is not None:
        topk.check(jcfg.n_layers)
    qat = quant != "none"
    np.testing.assert_allclose(float(pl), float(jl),
                               rtol=QAT_LOSS_RTOL if qat else LOSS_RTOL)
    want = leaves(_to_port(jg))
    assert len(pg) == len(want)
    ulps = QAT_GRAD_ULPS if qat else GRAD_ULPS
    for i, (got, w) in enumerate(zip(pg, want)):
        assert torch.isfinite(got).all(), i
        err = float((got - w).abs().max())
        ulp = _bf16_ulp(w.numpy())
        assert err <= ulps * ulp, (i, tuple(w.shape), err, ulp)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_every_grad_leaf_match_jax(arch, monkeypatch):
    """The MoE (with and without shared experts), SSM, hybrid and
    encoder-decoder smoke models: the loss (MoE: with its balance term)
    and every gradient leaf against ``jax.value_and_grad`` of the
    reference's loss (encoder-decoder: ``encdec_loss``, over the same bf16
    frames)."""
    _loss_and_grads_match(arch, "none", monkeypatch)


@pytest.mark.parametrize("arch", QAT)
def test_qat_loss_and_every_grad_leaf_match_jax(arch, monkeypatch):
    """``quant="qat-int8"``: every dense projection fake-quantizes its
    input and its f32 master weight, on both sides (the MoE's routed
    experts and router stay unquantized, as the reference's; an SSM's
    ``wx``, ``wz`` and ``wo`` are quantized, its ``wB``, ``wC``, ``wdt``
    not)."""
    _loss_and_grads_match(arch, "qat-int8", monkeypatch)


def test_qat_serving_matches_the_reference():
    """Prefill and 4 decode steps of the tinyllama smoke model with
    ``quant="qat-int8"`` (f32 masters): the same fake-quant runs in
    serving, the reference's ``decode_attn_block`` passing ``quant`` too;
    logits within the dense family's 2 bf16 ulps of their largest."""
    jcfg, jfns, jparams, pfns = _models("tinyllama-1.1b", "qat-int8")
    params = _to_port(jparams)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jcache, jlogits = jfns.prefill(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        cache, logits = pfns.prefill(params, {"tokens": torch.from_numpy(
            toks).long()})
        plain = pregistry.build(dataclasses.replace(
            pfns.cfg, quant="none")).prefill(params, {
                "tokens": torch.from_numpy(toks).long()})[1]
    assert not torch.equal(plain, logits)  # the fake-quant ran
    for i in range(5):
        err = np.abs(_np(logits) - _np(jlogits)).max()
        assert err <= 2 * _bf16_ulp(_np(jlogits)), (i, err)
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        if i == 4:
            break
        jlogits, jcache = jfns.decode(jparams, jcache, jnp.asarray(tok),
                                      jnp.int32(24 + i))
        with torch.no_grad():
            logits, cache = pfns.decode(params, cache,
                                        torch.from_numpy(tok).long(), 24 + i)


# --------------------------------------------------------------------------
# remat, the SSD scan's prefix sums
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,module", [
    ("deepseek-moe-16b", plm), ("mamba2-1.3b", plm),
    ("seamless-m4t-large-v2", pencdec)])
def test_remat_changes_no_bit_in_the_new_families(arch, module,
                                                  monkeypatch):
    """Each block checkpointed (encoder-decoder: every encoder and decoder
    block) gives the loss and every gradient bit for bit as without it:
    the recompute repeats the routing and the SSD scan."""
    jcfg, _, jparams, pfns = _models(arch, "qat-int8"
                                     if arch == "mamba2-1.3b" else "none")
    _, pb = _batch(jcfg, seed=4)
    params = _to_port(jparams)
    calls = []
    real = module.checkpoint

    def counted(fn, *a, **kw):
        calls.append(kw)
        return real(fn, *a, **kw)

    monkeypatch.setattr(module, "checkpoint", counted)
    l1, g1 = _grads(pfns.loss, params, pb)
    assert len(calls) == jcfg.n_layers + jcfg.n_enc_layers
    assert all(c == {"use_reentrant": False} for c in calls)
    monkeypatch.setattr(module, "checkpoint", lambda fn, *a, **kw: fn(*a))
    l2, g2 = _grads(pfns.loss, params, pb)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_the_hybrid_stack_is_not_checkpointed(monkeypatch):
    """hymba's stack runs unrolled with no remat, as the reference's."""
    jcfg, _, jparams, pfns = _models("hymba-1.5b")
    _, pb = _batch(jcfg, seed=4)
    monkeypatch.setattr(plm, "checkpoint", lambda *a, **kw: pytest.fail(
        "the hybrid stack was checkpointed"))
    loss, grads = _grads(pfns.loss, _to_port(jparams), pb)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)


@pytest.mark.parametrize("shape,dim", [((2, 3, 256, 5), 2), ((7, 33), 1),
                                       ((4, 9, 2), 0)])
def test_prefix_sum_is_cumsum_bit_for_bit(shape, dim):
    """The SSD scan's f64 prefix sums equal ``torch.cumsum`` (which sums f32
    in f64 on the CPU), values and gradient, bit for bit."""
    gen = torch.Generator().manual_seed(len(shape))
    x = (torch.randn(shape, generator=gen) * torch.rand(
        shape, generator=gen) * 10).requires_grad_(True)
    up = torch.randn(shape, generator=gen)
    got = pssm.prefix_sum(x, dim)
    want = torch.cumsum(x, dim)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    (g1,) = torch.autograd.grad(got, x, up)
    (g2,) = torch.autograd.grad(want, x, up)
    assert torch.equal(g1, g2)


# --------------------------------------------------------------------------
# Adam steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "seamless-m4t-large-v2"])
def test_adam_steps_match_jax_in_the_new_families(arch):
    """3 steps of Adam with clipping at a global norm of 1.0 against the
    reference's jitted ``make_train_step``, as for qwen2.5 in
    ``test_torch_lm_train.py``."""
    lr = 3e-4
    jcfg, jfns, jparams, pfns = _models(arch)
    jstep = jax.jit(jmake_train_step(jfns.loss, jopt.adam(lr)))
    jstate = jinit_train_state(jparams, jopt.adam(lr))
    pstep = make_train_step(pfns.loss, adam(lr), max_grad_norm=1.0)
    pstate = init_train_state(_to_port(jparams), adam(lr))
    for i in range(3):
        jb, pb = _batch(jcfg, seed=10 + i, b=4, s=16)
        jstate, jm = jstep(jstate, jb)
        pstate, pm = pstep(pstate, pb)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert int(pstate.step) == int(jstate.step) == 3
    for got, w in zip(leaves(pstate.params), leaves(_to_port(
            jstate.params))):
        assert float((got - w).abs().max()) <= 3 * 2 * lr + 1e-6


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,extra", [
    ("deepseek-moe-16b", []), ("mamba2-1.3b", []), ("hymba-1.5b", []),
    ("seamless-m4t-large-v2", []),
    ("tinyllama-1.1b", ["--quant", "qat-int8"])])
def test_launcher_trains_and_restarts_bit_for_bit(arch, extra, tmp_path):
    """Each new family, and QAT, through the LM launcher on the CPU (smoke
    config, 4 steps of 2 x 128 tokens: one routing group of 256 for MoE):
    the loss falls; a crash at step 3 (checkpoints every 2) restarted
    gives the uninterrupted run's losses and params bits; the report's
    quant and, for MoE, the balance term."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "128", "--ckpt-every", "2", *extra]
    whole = _launch(argv + ["--ckpt-dir", str(tmp_path / "a")])
    crashed = _launch(argv + ["--ckpt-dir", str(tmp_path / "b"),
                              "--inject-fault-at", "3"])
    assert list(whole["losses"]) == ["1", "2", "3", "4"]
    assert whole["last_loss"] < whole["first_loss"]
    assert crashed["losses"] == whole["losses"]
    assert crashed["params_digest"] == whole["params_digest"]
    assert crashed["train_step_calls"] == 5
    assert whole["quant"] == ("qat-int8" if extra else "none")
    balance = whole["balance_loss"]
    if arch.startswith("deepseek"):
        assert balance > 0 and balance == crashed["balance_loss"]
    else:
        assert balance is None
    assert whole["flash_attn_launches"] == 0  # the CPU: plain versions


def test_launcher_microbatches_cut_the_frames(tmp_path, monkeypatch):
    """``--microbatches 2`` on the encoder-decoder: each slice's loss sees
    its half of the frames beside its half of the tokens."""
    seen = []
    loss = pencdec.seq2seq_loss

    def recording(cfg, tp, params, batch):
        seen.append({k: tuple(v.shape) for k, v in batch.items()})
        return loss(cfg, tp, params, batch)

    monkeypatch.setattr(pencdec, "seq2seq_loss", recording)
    rep = _launch(["--arch", "seamless-m4t-large-v2", "--smoke", "--device",
                   "cpu", "--steps", "1", "--batch", "4", "--seq", "32",
                   "--microbatches", "2", "--grad-compress", "--ckpt-dir",
                   str(tmp_path)])
    assert rep["steps"] == 1 and np.isfinite(rep["first_loss"])
    assert seen == [{"tokens": (2, 32), "labels": (2, 32),
                     "frames": (2, 8, 64)}] * 2


def test_encdec_batches_carry_frames():
    """``lm_batches`` for the encoder-decoder: bf16 frames (B,
    enc_len_for(S), d) from a generator seeded by the step."""
    from repro_torch.data.lm_text import TextPipeline

    cfg = pconfigs.get_smoke("seamless-m4t-large-v2")
    at = train_launcher.lm_batches(cfg, TextPipeline(seq_len=40,
                                                     batch_size=3), "cpu")
    a, b = at(5), at(5)
    assert a["frames"].shape == (3, pencdec.enc_len_for(40), cfg.d_model)
    assert a["frames"].dtype == torch.bfloat16
    assert torch.equal(a["frames"], b["frames"])
    assert not torch.equal(a["frames"], at(6)["frames"])
    assert (a["labels"] >= 0).all() and sorted(a) == ["frames", "labels",
                                                      "tokens"]


def test_mrf_quant_flag_is_the_qat_backend(tmp_path):
    """As in the reference: ``--quant qat-int8`` on an MRF arch trains the
    ``qat-int8`` backend, and beside ``--backend fused`` it is refused."""
    rep = _launch(["--arch", "mrf-fpga", "--smoke", "--device", "cpu",
                   "--quant", "qat-int8", "--steps", "2", "--batch", "32",
                   "--ckpt-dir", str(tmp_path)])
    assert rep["backend"] == "qat-int8" and rep["steps"] == 2
    with pytest.raises(SystemExit, match="conflicts with --backend fused"):
        train_launcher.main(["--arch", "mrf-fpga", "--smoke", "--device",
                             "cpu", "--quant", "qat-int8", "--backend",
                             "fused"])


def test_launcher_without_checkpoints(tmp_path):
    """``--ckpt-every 0`` writes no checkpoint (not even step 0's) and a
    crash restarts from the initial state: the same losses and params bits
    as a run that checkpoints."""
    argv = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "32"]
    kept = _launch(argv + ["--ckpt-dir", str(tmp_path / "a")])
    none = _launch(argv + ["--ckpt-dir", str(tmp_path / "b"),
                           "--ckpt-every", "0", "--inject-fault-at", "2"])
    assert not (tmp_path / "b").exists() and (tmp_path / "a").exists()
    assert none["losses"] == kept["losses"]
    assert none["params_digest"] == kept["params_digest"]
    assert none["train_step_calls"] == 5  # steps 0-1, then 0-2 again


@pytest.mark.parametrize("ckpt_every", [0, 2])
def test_runner_holds_one_state(ckpt_every, tmp_path):
    """Given a function that makes the initial state (as the LM launcher
    passes it), the runner keeps no reference to that state once the first
    step has replaced it, or the step-0 checkpoint stands in for it: at
    full width the card holds one Adam state, not two.  Without
    checkpoints a restart makes it anew."""
    import gc
    import weakref

    from repro_torch.ft.runner import RunnerConfig, run

    made = []

    def make():
        state = {"w": torch.ones(4)}
        made.append(weakref.ref(state["w"]))
        return state

    def step(state, batch):
        return {"w": state["w"] + batch}, {"loss": state["w"].sum()}

    alive = []

    def on_metrics(step_no, metrics, dt):
        gc.collect()
        alive.append(made[-1]() is not None)

    cfg = RunnerConfig(total_steps=3, ckpt_dir=str(tmp_path),
                       ckpt_every=ckpt_every, inject_fault_at=2)
    state, n = run(step, make, lambda i: torch.full((4,), float(i)), cfg,
                   device="cpu", on_metrics=on_metrics)
    assert n == 3 and torch.equal(state["w"], torch.full((4,), 4.0))
    # steps 1-2, the crash, then steps 1-3 again (no checkpoint) or step 3
    # (from the step-2 checkpoint)
    assert alive == [False] * (5 if ckpt_every == 0 else 3)
    assert len(made) == (2 if ckpt_every == 0 else 1)

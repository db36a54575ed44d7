"""Port parity: LM training (``models.lm.cross_entropy`` and the family's
``loss``, ``data.lm_text``, the LM branch of ``launch.train``, the
training step on LM params) against the JAX package on identical numpy
params and batches, and the port's own contracts: remat changes no bit,
the LM ``TrainState`` checkpoints round-trip, crash + restart equals an
uninterrupted run bit for bit, the refusals, and no kernel wrapper hands
back an output without a gradient under grad.

Tolerances (bf16 activations, as in the reference; the two frameworks
round bf16 products at other places, ``test_torch_lm.py``):
* ``cross_entropy`` on f32 logits: rtol 1e-6 (loss) and 1e-5 (grads).
* the loss of a smoke model: rtol ``LOSS_RTOL`` = 1e-4 (the logits differ
  by up to 2 bf16 ulps of their largest, and the mean over the tokens
  averages most of it out; seen: 3e-5).
* every gradient leaf: within ``GRAD_ULPS`` = 8 bf16 ulps of the leaf's
  largest magnitude (each leaf's gradient passes through the bf16 chain
  of the whole backward, attention's P and dS rounded at other places
  than XLA's; seen: up to 4.8).
* 3 Adam steps with clipping: losses as above; params within ``2 lr`` a
  step of the reference's (Adam's first steps move an element by about
  ``lr * sign(g)``: a gradient near 0 whose sign differs between the two
  moves it by ``2 lr``), and the global norm at rtol 1e-3.
* Inside the port (remat, restarts, checkpoints): bit for bit.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.data.lm_text import TextPipeline as JTextPipeline
from repro.models import lm as jlm
from repro.models.encdec import enc_len_for as jenc_len_for
from repro.models import registry as jregistry
from repro.optim import optimizers as jopt
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs as pconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.lm_text import TextPipeline
from repro_torch.ft.checkpoint import restore_state, save_state
from repro_torch.kernels.fused_train import kernel as train_kernel
from repro_torch.kernels.fused_train import multistep
from repro_torch.kernels.qat_dense import fused as fused_fwd
from repro_torch.kernels.qat_dense import kernel as qat_kernel
from repro_torch.launch import train as train_launcher
from repro_torch.models import encdec as pencdec
from repro_torch.models import lm as plm
from repro_torch.models import registry as pregistry
from repro_torch.optim import adam
from repro_torch.tree import leaves, rebuild
from repro_torch.train.step import init_train_state, make_train_step

DENSE = ["tinyllama-1.1b", "granite-8b", "qwen2.5-14b"]
LOSS_RTOL = 1e-4
GRAD_ULPS = 8


def _models(arch, quant="none"):
    jcfg = dataclasses.replace(jget_smoke(arch), quant=quant)
    pcfg = dataclasses.replace(pconfigs.get_smoke(arch), quant=quant)
    jfns, pfns = jregistry.build(jcfg), pregistry.build(pcfg)
    jparams = jfns.init(jax.random.PRNGKey(0))
    if jcfg.qkv_bias:  # the init's biases are zero: make them count
        a = jparams["layers"]["attn"]
        keys = jax.random.split(jax.random.PRNGKey(1), 3)
        jparams["layers"]["attn"] = a._replace(**{
            n: 0.1 * jax.random.normal(kk, getattr(a, n).shape)
            for n, kk in zip(("bq", "bk", "bv"), keys)})
    return jcfg, jfns, jparams, pfns


def _to_port(tree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _batch(cfg, seed, b=2, s=32):
    """The same batch for both: tokens, labels with some masked; for the
    VLM its prefix embeddings over positions whose labels are -1, for the
    encoder-decoder its ``enc_len_for(s)`` frames (both rounded to bf16
    once)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labs[0, :5] = -1
    jb = {"tokens": jnp.asarray(toks)}
    pb = {"tokens": torch.from_numpy(toks).long()}

    def bf16(name, rows):
        arr = jnp.asarray(0.02 * rng.standard_normal(
            (b, rows, cfg.d_model))).astype(jnp.bfloat16)
        jb[name] = arr
        pb[name] = torch.from_numpy(
            np.array(arr.astype(jnp.float32))).to(torch.bfloat16)

    if cfg.family == "vlm":
        bf16("prefix_embeds", cfg.n_prefix_embeds)
        labs[:, :cfg.n_prefix_embeds] = -1
    if cfg.family == "encdec":
        bf16("frames", jenc_len_for(s))
    jb["labels"] = jnp.asarray(labs)
    pb["labels"] = torch.from_numpy(labs).long()
    return jb, pb


def _grads(loss_fn, params, batch):
    """The loss and every gradient leaf; a param the loss does not reach
    (``ln2`` under parallel_block) gets zeros, as ``jax.grad`` gives."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = loss_fn(rebuild(params, live), batch)
    return loss.detach(), torch.autograd.grad(loss, live,
                                              materialize_grads=True)


def _bf16_ulp(x) -> float:
    m = float(np.abs(np.asarray(x, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("true_vocab", [40, 37])
def test_cross_entropy_matches_jax(true_vocab):
    """f32 logits over a padded vocab (columns past ``true_vocab`` at -1e30)
    and masked labels: the loss and its gradient."""
    rng = np.random.default_rng(0)
    lg = rng.normal(size=(2, 6, 40)).astype(np.float32) * 3
    labs = rng.integers(0, true_vocab, (2, 6)).astype(np.int32)
    labs[1, 2:] = -1
    jl, jg = jax.value_and_grad(jlm.cross_entropy)(
        jnp.asarray(lg), jnp.asarray(labs), true_vocab)
    x = torch.from_numpy(lg).requires_grad_(True)
    pl = plm.cross_entropy(x, torch.from_numpy(labs).long(), true_vocab)
    (pg,) = torch.autograd.grad(pl, x)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-8)
    none = plm.cross_entropy(x, torch.full((2, 6), -1), true_vocab)
    assert float(none.detach()) == 0.0  # every label masked: 0 / max(0, 1)


@pytest.mark.parametrize("arch", DENSE + ["llava-next-34b"])
def test_loss_and_every_grad_leaf_match_jax(arch):
    jcfg, jfns, jparams, pfns = _models(arch)
    jb, pb = _batch(jcfg, seed=3)
    jl, jg = jax.jit(jax.value_and_grad(jfns.loss))(jparams, jb)
    pl, pg = _grads(pfns.loss, _to_port(jparams), pb)
    np.testing.assert_allclose(float(pl), float(jl), rtol=LOSS_RTOL)
    want = leaves(_to_port(jg))
    assert len(pg) == len(want)
    for got, w in zip(pg, want):
        err = float((got - w).abs().max())
        assert err <= GRAD_ULPS * _bf16_ulp(w.numpy()), (err, _bf16_ulp(w))


def test_remat_changes_no_bit(monkeypatch):
    """``remat="full"`` checkpoints each block: the loss and every gradient
    are the same bits as without it (the recompute repeats the forward)."""
    jcfg, _, jparams, pfns = _models("tinyllama-1.1b")
    _, pb = _batch(jcfg, seed=4)
    params = _to_port(jparams)
    calls = []
    real = plm.checkpoint

    def counted(fn, *a, **kw):
        calls.append(kw)
        return real(fn, *a, **kw)

    monkeypatch.setattr(plm, "checkpoint", counted)
    l1, g1 = _grads(pfns.loss, params, pb)
    assert len(calls) == jcfg.n_layers and \
        all(c == {"use_reentrant": False} for c in calls)
    monkeypatch.setattr(plm, "checkpoint", lambda fn, *a, **kw: fn(*a))
    l2, g2 = _grads(pfns.loss, params, pb)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    with torch.no_grad():  # no checkpoint without grad
        monkeypatch.setattr(plm, "checkpoint", counted)
        calls.clear()
        pfns.loss(params, pb)
        assert not calls


def test_moe_loss_adds_the_balance_term():
    """The MoE family's loss adds ``MOE_LOSS_COEF * aux / n_layers`` (the
    reference's coefficient), aux summed over the blocks."""
    cfg = pconfigs.get_smoke("deepseek-moe-16b")
    fns = pregistry.build(cfg)
    params = fns.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 256),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        h = plm._embed(params, toks)
        h, _, aux = plm._stack_forward(cfg, 1, params, h, collect_kv=False)
        h = plm.rms_norm(h, params["final_norm"], cfg.norm_eps)
        ce = plm.cross_entropy(plm._logits(params, h), toks, cfg.vocab_size)
        loss = fns.loss(params, batch)
    assert float(aux) > 0
    assert plm.MOE_LOSS_COEF == getattr(jlm, "MOE_" + "AUX_COEF")
    assert torch.equal(loss, ce + plm.MOE_LOSS_COEF * aux / cfg.n_layers)


def test_registry_losses():
    """Every LM family trains: the decoder-only families' loss is
    ``next_token_loss``, the encoder-decoder's ``seq2seq_loss`` (each
    checked against the reference in ``test_torch_lm_train_families.py``);
    ``qat-int8`` validates, and so do the dry-run's levers ``int8-hlo``,
    ``save_attn`` and ``parallel_block``, whose losses train (held against
    the reference in ``test_torch_perf_levers.py``)."""
    for arch in ("tinyllama-1.1b", "llava-next-34b", "deepseek-moe-16b",
                 "mamba2-1.3b", "hymba-1.5b"):
        assert pregistry.build(pconfigs.get_smoke(arch)).loss.func is \
            plm.next_token_loss
    assert pregistry.build(pconfigs.get_smoke(
        "seamless-m4t-large-v2")).loss.func is pencdec.seq2seq_loss
    cfg = pconfigs.get_smoke("tinyllama-1.1b")
    assert dataclasses.replace(cfg, quant="qat-int8").validate()
    for lever in (dict(remat="save_attn"), dict(parallel_block=True),
                  dict(quant="int8-hlo")):
        fns = pregistry.build(dataclasses.replace(cfg, **lever))
        assert fns.loss.func is plm.next_token_loss
        assert dataclasses.asdict(fns.cfg).items() >= lever.items()


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_adam_steps_with_clipping_match_jax(microbatches):
    """3 steps of Adam with clipping at a global norm of 1.0 (the smoke
    models' norm is ~2, so the clip bites), against the reference's jitted
    ``make_train_step`` on the same batches."""
    lr = 3e-4
    jcfg, jfns, jparams, pfns = _models("qwen2.5-14b")
    jstep = jax.jit(jmake_train_step(jfns.loss, jopt.adam(lr),
                                     microbatches=microbatches))
    jstate = jinit_train_state(jparams, jopt.adam(lr))
    pstep = make_train_step(pfns.loss, adam(lr), microbatches=microbatches,
                            max_grad_norm=1.0)
    pstate = init_train_state(_to_port(jparams), adam(lr))
    for i in range(3):
        jb, pb = _batch(jcfg, seed=10 + i, b=4, s=16)
        jstate, jm = jstep(jstate, jb)
        pstate, pm = pstep(pstate, pb)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        assert float(jm["grad_norm"]) > 1.0
    assert int(pstate.step) == int(jstate.step) == 3
    assert int(pstate.opt_state.step) == 3
    for got, w in zip(leaves(pstate.params), leaves(_to_port(
            jstate.params))):
        assert float((got - w).abs().max()) <= 3 * 2 * lr + 1e-6


def test_microbatches_cut_a_token_batch_as_the_reference():
    """``microbatches=M`` hands the loss the slices the reference's
    ``resh`` makes: entry i of each leaf's (M, B/M, ...) reshape."""
    seen = []

    def loss_fn(params, batch):
        seen.append({k: v.clone() for k, v in batch.items()})
        return (params["w"] * batch["prefix_embeds"].float().mean()).sum()

    rng = np.random.default_rng(0)
    host = {"tokens": rng.integers(0, 9, (6, 5)),
            "labels": rng.integers(-1, 9, (6, 5)),
            "prefix_embeds": rng.normal(size=(6, 2, 3)).astype(np.float32)}
    params = {"w": torch.ones(3)}
    step = make_train_step(loss_fn, adam(1e-3), microbatches=3)
    step(init_train_state(params, adam(1e-3)),
         {k: torch.from_numpy(v) for k, v in host.items()})
    assert len(seen) == 3
    for i, got in enumerate(seen):
        for k, v in host.items():
            np.testing.assert_array_equal(
                got[k].numpy(), v.reshape(3, 2, *v.shape[1:])[i])


def test_lm_train_state_round_trips(tmp_path):
    """An LM ``TrainState`` (a list of layer dicts of NamedTuples, some
    fields None; f32 masters; Adam's moments; the step counters) saves and
    restores bit for bit, structure and types included."""
    jcfg, _, jparams, pfns = _models("qwen2.5-14b")
    opt = adam(1e-3)
    state = init_train_state(_to_port(jparams), opt)
    _, pb = _batch(jcfg, seed=5)
    state, _ = make_train_step(pfns.loss, opt)(state, pb)
    save_state(state, tmp_path, 1, async_io=False)
    like = init_train_state(pfns.init(1, device="cpu"), opt)
    back = restore_state(like, tmp_path, device="cpu")
    assert type(back.params["layers"][0]["attn"]) is \
        type(state.params["layers"][0]["attn"])
    la, lb = leaves(back), leaves(state)
    assert len(la) == len(lb)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(la, lb))
    assert int(back.opt_state.step) == 1


# --------------------------------------------------------------------------
# data and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts", [1, 2])
def test_text_pipeline_matches_the_reference(n_hosts):
    for host in range(n_hosts):
        kw = dict(seq_len=48, batch_size=8, vocab_size=200, seed=3,
                  n_hosts=n_hosts, host=host)
        mine, ref = TextPipeline(**kw), JTextPipeline(**kw)
        assert mine.tokens_per_batch == ref.tokens_per_batch
        for step in (0, 1, 7, 1000):
            got, want = mine.batch_at(step), ref.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_vlm_batches_mask_the_prefix():
    cfg = pconfigs.get_smoke("llava-next-34b")
    at = train_launcher.lm_batches(cfg, TextPipeline(seq_len=16,
                                                     batch_size=2), "cpu")
    a, b = at(3), at(3)
    p = cfg.n_prefix_embeds
    assert a["prefix_embeds"].shape == (2, p, cfg.d_model)
    assert a["prefix_embeds"].dtype == torch.bfloat16
    assert torch.equal(a["prefix_embeds"], b["prefix_embeds"])
    assert not torch.equal(a["prefix_embeds"], at(4)["prefix_embeds"])
    assert (a["labels"][:, :p] == -1).all() and (a["labels"][:, p:] >= 0).all()
    assert a["tokens"].dtype == torch.int64


def _launch(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_launcher.main(argv)
    last = buf.getvalue().splitlines()[-1]
    assert rc == 0 and last.startswith("train_report ")
    return json.loads(last[len("train_report "):])


def test_lm_launcher_trains_and_restarts_bit_for_bit(tmp_path):
    """The LM launcher on the CPU (smoke tinyllama, 4 steps): the report's
    losses fall; a crash at step 3 (checkpoints every 2) and its restart
    give the same losses and params bits as the uninterrupted run; the
    plain versions ran (no kernel launches)."""
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "32", "--ckpt-every",
            "2"]
    whole = _launch(argv + ["--ckpt-dir", str(tmp_path / "a")])
    crashed = _launch(argv + ["--ckpt-dir", str(tmp_path / "b"),
                              "--inject-fault-at", "3"])
    assert whole["steps"] == crashed["steps"] == 4
    assert list(whole["losses"]) == ["1", "2", "3", "4"]
    assert whole["last_loss"] < whole["first_loss"]
    assert crashed["losses"] == whole["losses"]
    assert crashed["params_digest"] == whole["params_digest"]
    assert whole["train_step_calls"] == 4 and \
        crashed["train_step_calls"] == 5  # steps 0-2, then 2-3 again
    assert whole["flash_attn_launches"] == 0 == \
        whole["flash_attn_bwd_launches"]
    assert whole["tokens_per_s"] > 0 and whole["peak_device_gib"] is None


def test_lm_launcher_vlm_microbatches_and_compression(tmp_path):
    rep = _launch(["--arch", "llava-next-34b", "--smoke", "--device", "cpu",
                   "--steps", "2", "--batch", "4", "--seq", "16",
                   "--microbatches", "2", "--grad-compress", "--ckpt-dir",
                   str(tmp_path)])
    assert rep["steps"] == 2 and rep["microbatches"] == 2
    assert all(np.isfinite(v) for v in rep["losses"].values())


@pytest.mark.parametrize("argv,what", [
    (["--arch", "tinyllama-1.1b", "--quant", "int8-hlo"], "2"),
    (["--arch", "mrf-fpga", "--quant", "qat-int8", "--backend", "fused"],
     "conflicts with --backend fused"),
    (["--arch", "deepseek-moe-16b", "--batch", "3", "--seq", "100"],
     "routing groups of 256"),
    (["--arch", "llava-next-34b", "--seq", "4"], "prefix embeddings"),
])
def test_lm_launcher_refusals(argv, what):
    """What the launcher still refuses, before any weight is made: the
    int8 dots (not a ``--quant`` choice: ROADMAP.md §A 5), QAT beside the
    fused MRF kernel (as the reference), MoE tokens that are not whole
    routing groups, a VLM sequence shorter than its prefix.  The families
    it refused until now train (``test_torch_lm_train_families.py``)."""
    with pytest.raises(SystemExit, match=what):
        train_launcher.main(argv + ["--smoke", "--device", "cpu"])


# --------------------------------------------------------------------------
# no kernel output drops a gradient
# --------------------------------------------------------------------------

def test_kernel_wrappers_refuse_a_gradient_on_the_cpu_too():
    """B4, B5 and B1-B3 compute no gradient on either device: under grad
    with an input that requires one they raise, here as on the card (where
    their ctypes launches would hand back outputs without a ``grad_fn``);
    under ``no_grad`` they run."""
    x = torch.zeros((4, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_fwd.fused_forward_call(x, None)
    scale = torch.ones(8, requires_grad=True)
    xq = torch.zeros((4, 16), dtype=torch.int8)
    wq = torch.zeros((16, 8), dtype=torch.int8)
    bq = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="requires grad"):
        qat_kernel.qat_dense_call(xq, wq, bq, scale)
    with torch.no_grad():
        assert qat_kernel.qat_dense_call(xq, wq, bq, scale).shape == (4, 8)
    widths = (8, 4, 2)
    params = torch.zeros(8 * 4 + 4 + 4 * 2 + 2, requires_grad=True)
    y = torch.zeros((4, 2))
    for call in (train_kernel.fused_train_call,
                 multistep.fused_train_multistep_call):
        with pytest.raises(RuntimeError, match="requires grad"):
            call(x, y, params, widths=widths, lr=0.1, tile_batch=4)
    mu = torch.zeros_like(params)
    with pytest.raises(RuntimeError, match="requires grad"):
        multistep.fused_train_adam_call(
            torch.zeros(1, dtype=torch.int32), x.detach(), y, params, mu, mu,
            widths=widths, lr=0.1, tile_batch=4)
    with torch.no_grad():
        p, losses = train_kernel.fused_train_call(
            x, y, params, widths=widths, lr=0.1, tile_batch=4)
    assert p.shape == params.shape and losses.shape == (1,)

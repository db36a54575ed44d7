"""Port parity: the encoder-decoder family (seamless-m4t-large-v2) —
``configs``, cross-attention in ``models/attention``, ``models/encdec``,
``convert``, the token launcher — against the JAX package on identical
numpy inputs; the reference's params cross over with
``convert.lm_params_from_numpy``, its model is reached through
``repro.models.registry.build`` and runs jitted; attention runs B6's plain
version here.

Tolerances, those of ``tests/test_torch_lm.py``:
* f32: the attention blocks at rtol 1e-5, atol 1e-5 (sum order, and B6's
  online softmax against the reference's full softmax);
* bf16 per block: within one bf16 ulp of the output's largest magnitude
  (``bf16_ulp``);
* bf16 through the whole model (smoke config, prefill and 4 teacher-forced
  decode steps): logits and the four caches within ``SLICE_ULPS`` = 2 such
  ulps (at most 2 measured over these cases); greedy tokens equal wherever
  the reference's top-2 margin exceeds twice that.
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

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.models.encdec import enc_len_for as jenc_len_for
from repro_torch import configs as pconfigs
from repro_torch.configs import base as pbase
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attn.kernel import flash_attention_call
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import attention as pattn
from repro_torch.models import encdec as pencdec
from repro_torch.models import registry as pregistry
from repro_torch.tree import leaves

ARCH = "seamless-m4t-large-v2"
F32 = dict(rtol=1e-5, atol=1e-5)
SLICE_ULPS = 2
CACHES = ("k", "v", "cross_k", "cross_v")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_ulp(x) -> float:
    """The spacing of bf16 numbers at ``max |x|``."""
    return 2.0 ** (np.floor(np.log2(np.abs(_np(x)).max())) - 7)


def _pair(arr, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``,
    rounded once for both."""
    j = jnp.asarray(arr).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        assert got.dtype == torch.bfloat16
        assert np.abs(_np(got) - _np(want)).max() <= bf16_ulp(want)


def _slice_close(got, want, what):
    tol = SLICE_ULPS * bf16_ulp(want)
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= tol, f"{what}: max abs err {err} > {tol}"
    return tol


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

FIELDS = ("name", "family", "n_layers", "n_enc_layers", "n_prefix_embeds",
          "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
          "head_dim", "qkv_bias", "gated_mlp", "rope_theta", "norm_eps",
          "swa_window", "quant")


def test_encdec_config_matches_jax():
    for get, jget in ((pconfigs.get_config, jget_config),
                      (pconfigs.get_smoke, jget_smoke)):
        p, j = get(ARCH), jget(ARCH)
        assert [getattr(p, f) for f in FIELDS] == \
            [getattr(j, f) for f in FIELDS]
        assert p.padded_heads(1) == j.padded_heads(1)
        assert p.padded_vocab(1) == j.padded_vocab(1)
        assert pbase.param_count(p) == jbase.param_count(j)
    smoke = pconfigs.get_smoke(ARCH)
    assert (smoke.n_layers, smoke.n_enc_layers) == (2, 2)


def test_full_size_count_and_the_tensors_count():
    cfg = pconfigs.get_config(ARCH)
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.head_dim) == (24, 24, 64)
    assert pbase.param_count(cfg) == 2_034_784_256  # 3.79 GiB in bf16
    smoke = pconfigs.get_smoke(ARCH)
    params = pregistry.build(smoke).init(0, device="cpu")
    assert sum(t.numel() for t in leaves(params)) == pbase.param_count(smoke)
    assert len(params["enc"]["layers"]) == len(params["dec"]["layers"]) == 2
    assert set(params["dec"]["layers"][0]) == {"ln1", "attn", "ln_cross",
                                               "cross", "ln2", "mlp"}


@pytest.mark.parametrize("seq", [1, 8, 31, 32, 50, 2048])
def test_enc_len_for_matches_jax(seq):
    assert pencdec.enc_len_for(seq) == jenc_len_for(seq)


# --------------------------------------------------------------------------
# cross-attention
# --------------------------------------------------------------------------

def _attn_params(seed, d, hq, hkv, dh):
    jp = jattn.init_attn(jcommon.key_iter(jax.random.PRNGKey(seed)), d, hq,
                         hkv, dh)
    pp = pattn.AttentionParams(*(None if a is None else torch.from_numpy(
        np.array(a)) for a in jp))
    return jp, pp


@pytest.mark.parametrize("sk", [12, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_block_with_kv_source(sk, dtype):
    """Cross-attention: K/V from the encoder states, no RoPE on either
    side, unmasked over all ``sk`` of them (fewer or more than the
    queries)."""
    rng = np.random.default_rng(10)
    heads = (4, 2, 16)
    jp, pp = _attn_params(10, 64, *heads)
    jx, px = _pair(rng.normal(size=(2, 24, 64)), dtype)
    je, pe = _pair(rng.normal(size=(2, sk, 64)), dtype)
    jy, (jk, jv) = jattn.attn_block(jp, jx, cfg_heads=heads, rope_theta=1e4,
                                    causal=False, return_kv=True,
                                    kv_source=je)
    py, (pk, pv) = pattn.attn_block(pp, px, cfg_heads=heads, rope_theta=1e4,
                                    causal=False, return_kv=True,
                                    kv_source=pe)
    assert pk.shape == (2, sk, 2, 16)
    for got, want in ((py, jy), (pk, jk), (pv, jv)):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attn_block_with_cross_kv(dtype):
    """One token over the static cross cache: q not rotated, every slot
    attended, the self-attention caches returned untouched."""
    rng = np.random.default_rng(11)
    heads = (4, 2, 16)
    jp, pp = _attn_params(11, 64, *heads)
    jx1, px1 = _pair(rng.normal(size=(2, 64)), dtype)
    (jck, pck), (jcv, pcv) = (_pair(rng.normal(size=(2, 12, 2, 16)), dtype)
                              for _ in range(2))
    (jk, pk), (jv, pv) = (_pair(rng.normal(size=(2, 24, 2, 16)), dtype)
                          for _ in range(2))
    k0, v0 = pk.clone(), pv.clone()
    jy, jk2, jv2 = jattn.decode_attn_block(
        jp, jx1, jk, jv, jnp.int32(30), cfg_heads=heads, rope_theta=1e4,
        cross_kv=(jck, jcv))
    py, pk2, pv2 = pattn.decode_attn_block(
        pp, px1, pk, pv, 30, cfg_heads=heads, rope_theta=1e4,
        cross_kv=(pck, pcv))
    _close(py, jy, dtype)
    assert pk2 is pk and pv2 is pv
    assert torch.equal(pk, k0) and torch.equal(pv, v0)
    np.testing.assert_array_equal(_np(jk2), _np(jk))


# --------------------------------------------------------------------------
# the whole family
# --------------------------------------------------------------------------

def _models():
    jcfg, pcfg = jget_smoke(ARCH), pconfigs.get_smoke(ARCH)
    jfns, pfns = jregistry.build(jcfg), pregistry.build(pcfg)
    jfns = dataclasses.replace(jfns, prefill=jax.jit(jfns.prefill),
                               decode=jax.jit(jfns.decode))
    jparams = jfns.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return jcfg, jfns, jparams, pfns, params


def _batch(seed, b, s, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    frames = (0.02 * rng.normal(size=(b, jenc_len_for(s), 64))).astype(
        np.float32)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)})


def _greedy_agrees(plogits, jlogits, tol):
    want = _np(jlogits)
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(_np(plogits).argmax(-1)[sure],
                                  want.argmax(-1)[sure])


@pytest.mark.parametrize("s", [24, 50])  # 8 frames (the floor); ragged 12
def test_prefill_and_four_decode_steps_match_jax(s):
    jcfg, jfns, jparams, pfns, params = _models()
    jbatch, pbatch = _batch(6, 2, s, jcfg.vocab_size)
    jcache, jlogits = jfns.prefill(jparams, jbatch)
    with torch.no_grad():
        cache, logits = pfns.prefill(params, pbatch)
    se = jenc_len_for(s)
    assert {n: tuple(t.shape) for n, t in cache.items()} == {
        "k": (2, 2, s, 2, 16), "v": (2, 2, s, 2, 16),
        "cross_k": (2, 2, se, 2, 16), "cross_v": (2, 2, se, 2, 16)}
    assert all(t.dtype == torch.bfloat16 for t in cache.values())
    tol = _slice_close(logits, jlogits, "prefill logits")
    _greedy_agrees(logits, jlogits, tol)
    for name in CACHES:
        _slice_close(cache[name], jcache[name], f"prefill cache {name}")
    cross = {n: cache[n].clone() for n in ("cross_k", "cross_v")}
    # teacher-forced with the reference's tokens: steps 0-3 overwrite the
    # prompt's self-attention slots 0-3 at absolute positions s..s+3; the
    # cross cache is never written
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for i in range(4):
        jlogits, jcache = jfns.decode(jparams, jcache, jnp.asarray(tok),
                                      jnp.int32(s + i))
        with torch.no_grad():
            logits, cache2 = pfns.decode(params, cache,
                                         torch.from_numpy(tok), s + i)
        assert cache2 is cache
        tol = _slice_close(logits, jlogits, f"decode step {i} logits")
        _greedy_agrees(logits, jlogits, tol)
        for name in CACHES:
            _slice_close(cache[name], jcache[name], f"step {i} cache {name}")
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    assert all(torch.equal(cache[n], t) for n, t in cross.items())


def test_every_prefill_attention_runs_on_b6(monkeypatch):
    """B6's wrapper takes the encoder's unmasked self-attention over the
    frames, the decoder's causal self-attention and its cross-attention
    (unmasked, Sq the prompt, Sk the frames): 3 calls a layer pair."""
    cfg = pconfigs.get_smoke(ARCH)
    fns = pregistry.build(cfg)
    params = fns.init(0, device="cpu", dtype=torch.bfloat16)
    seen = []
    original = pattn.flash_attention

    def recording(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw["causal"]))
        return original(q, k, v, **kw)

    monkeypatch.setattr(pattn, "flash_attention", recording)
    _, pbatch = _batch(7, 1, 50, cfg.vocab_size)
    with torch.no_grad():
        fns.prefill(params, pbatch)
    assert seen == [(12, 12, False)] * 2 + [(50, 50, True),
                                            (50, 12, False)] * 2


def test_init_cache_and_the_bf16_copy():
    jcfg, pcfg = jget_smoke(ARCH), pconfigs.get_smoke(ARCH)
    fns = pregistry.build(pcfg)
    want = jregistry.build(jcfg).init_cache(2, 40)
    got = fns.init_cache(2, 40, device="cpu")
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        {n: tuple(t.shape) for n, t in want.items()}
    assert not any(t.any() for t in got.values())
    masters = fns.init(3, device="cpu")
    copy = fns.init(3, device="cpu", dtype=torch.bfloat16)
    assert all(torch.equal(c, m.to(torch.bfloat16))
               for c, m in zip(leaves(copy), leaves(masters)))
    _, pbatch = _batch(8, 1, 16, pcfg.vocab_size)
    with torch.no_grad():
        assert torch.equal(fns.prefill(masters, pbatch)[1],
                           fns.prefill(copy, pbatch)[1])
        # the loss trains now (tests/test_torch_lm_train_families.py holds
        # it against the reference): from the masters and the bf16 copy alike
        pbatch["labels"] = pbatch["tokens"]
        assert torch.equal(fns.loss(masters, pbatch), fns.loss(copy, pbatch))
    assert fns.loss.func is pencdec.seq2seq_loss


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_launcher.main(argv)
    return rc, buf.getvalue()


def test_token_serve_launcher_on_the_cpu():
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
            "--prompt-len", "50", "--gen-len", "4"]
    before = flash_attention_call.launches
    reports = []
    for _ in range(2):
        rc, out = _run(argv)
        assert rc == 0
        last = out.splitlines()[-1]
        assert last.startswith("token_report ")
        reports.append(json.loads(last.split(" ", 1)[1]))
    rep = reports[0]
    assert (rep["arch"], rep["requests"], rep["prompt"], rep["gen"]) == \
        (f"{ARCH}-smoke", 2, 50, 4)
    assert np.array(rep["tokens"]).shape == (2, 4)
    assert rep["tokens"] == reports[1]["tokens"]  # greedy, seeded
    assert rep["flash_attn_launches"] == 0  # the CPU runs the plain version
    assert flash_attention_call.launches == before


def test_token_batch_makes_the_frames():
    cfg = pconfigs.get_smoke(ARCH)
    gen = torch.Generator().manual_seed(1)
    batch = serve_launcher.token_batch(cfg, 3, 50, gen, torch.device("cpu"))
    assert batch["tokens"].shape == (3, 50)
    assert batch["frames"].shape == (3, 12, 64)
    assert batch["frames"].dtype == torch.bfloat16
    assert 0.01 < float(batch["frames"].float().std()) < 0.04

"""Port parity: the dense LM family (``models/{common,attention,mlp,lm}``,
``serve/decode``, the token branch of ``launch/serve``) against the JAX
package on identical numpy inputs; the reference's params cross over with
``convert.lm_params_from_numpy``.  Attention runs B6's plain version here.

Tolerances:
* f32: rms_norm, RoPE, the MLP, attention, decode attention and the
  attention block at rtol 1e-5, atol 1e-5 (sum order, and the online
  softmax of B6 against the reference's full softmax).
* bf16 per op: within one bf16 ulp of the output's largest magnitude
  (``bf16_ulp``) — the two frameworks round bf16 dots and the
  probabilities of the two softmax forms at other places; the MLP at
  these shapes bit for bit.
* bf16 through the whole model (smoke configs, prefill and 4 decode
  steps): logits and caches within ``SLICE_ULPS`` = 2 such ulps; greedy
  tokens equal wherever the reference's top-2 margin exceeds twice that.
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
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import registry as jregistry
from repro_torch import configs as pconfigs
from repro_torch.configs import base as pbase
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attn.kernel import flash_attention_call
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import attention as pattn
from repro_torch.models import common as pcommon
from repro_torch.models import encdec as pencdec
from repro_torch.models import lm as plm
from repro_torch.models import mlp as pmlp
from repro_torch.models import registry as pregistry
from repro_torch.serve.decode import make_prefill_step, make_serve_step
from repro_torch.tree import leaves

DENSE = ["tinyllama-1.1b", "granite-8b", "qwen2.5-14b", "minitron-8b"]
SLICE = ["tinyllama-1.1b", "minitron-8b", "qwen2.5-14b"]
F32 = dict(rtol=1e-5, atol=1e-5)
SLICE_ULPS = 2


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


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_match_jax(arch):
    fields = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size", "head_dim", "qkv_bias",
              "gated_mlp", "rope_theta", "norm_eps", "swa_window", "quant")
    for get, jget in ((pconfigs.get_config, jget_config),
                      (pconfigs.get_smoke, jget_smoke)):
        p, j = get(arch), jget(arch)
        assert [getattr(p, f) for f in fields] == \
            [getattr(j, f) for f in fields]
        assert p.padded_heads(1) == j.padded_heads(1)
        assert p.padded_vocab(1) == j.padded_vocab(1)
        assert pbase.param_count(p) == jbase.param_count(j)


def test_config_refusals():
    """Every family of the reference validates, and LM QAT; tp > 1 pads
    the heads (``tests/test_torch_dist_sharding.py`` holds every arch
    against the reference); the dry-run's levers (``int8-hlo``,
    ``save_attn``, ``parallel_block``) validate; an unknown family, quant,
    remat or arch is refused."""
    cfg = pconfigs.get_config("tinyllama-1.1b")
    assert cfg.head_dim == 64 and pbase.param_count(cfg) == 1_100_048_384
    assert cfg.padded_heads(2) == (32, 4) and cfg.padded_heads(3) == (33, 3)
    for family in ("encdec", "vlm"):
        assert dataclasses.replace(cfg, family=family).validate().family \
            == family
    assert {c.family for c in map(pconfigs.get_config, pconfigs.ARCHS)} == \
        set(pbase.PORTED_FAMILIES)
    with pytest.raises(ValueError, match="unknown family"):
        dataclasses.replace(cfg, family="rnn").validate()
    assert dataclasses.replace(cfg, quant="qat-int8").validate().quant == \
        "qat-int8"
    lever = dataclasses.replace(cfg, quant="int8-hlo", remat="save_attn",
                                parallel_block=True)
    assert lever.validate() is lever
    with pytest.raises(ValueError, match="quant='int4'"):
        dataclasses.replace(cfg, quant="int4").validate()
    with pytest.raises(ValueError, match="remat='dots'"):
        dataclasses.replace(cfg, remat="dots").validate()
    with pytest.raises(KeyError, match="unknown arch"):
        pconfigs.get_config("gpt-17")
    assert pconfigs.get_config("seamless-m4t-large-v2").family == "encdec"


def test_registry_builds_the_ported_families():
    """Every family serves and trains: the dense and VLM families' loss is
    the LM loss (``tests/test_torch_lm_train.py`` holds it against the
    reference), the encoder-decoder's ``seq2seq_loss``
    (``tests/test_torch_lm_train_families.py``)."""
    assert pregistry.build(pconfigs.get_smoke("mrf-fpga")).predict is not None
    fns = pregistry.build(pconfigs.get_smoke("tinyllama-1.1b"))
    assert fns.prefill is not None and fns.decode is not None
    assert fns.loss.func is plm.next_token_loss
    for arch in ("seamless-m4t-large-v2", "llava-next-34b"):
        built = pregistry.build(pconfigs.get_smoke(arch))
        assert built.prefill is not None and built.decode is not None
    assert built.loss.func is plm.next_token_loss  # llava
    assert pregistry.build(pconfigs.get_smoke(
        "seamless-m4t-large-v2")).loss.func is pencdec.seq2seq_loss
    # tp > 1 builds (padded heads; tests/test_torch_dist_sharding.py holds
    # the axes trees against the reference)
    at_tp2 = pregistry.build(pconfigs.get_smoke("seamless-m4t-large-v2"), tp=2)
    assert at_tp2.param_axes()["dec"]["embed"] == ("tp", "fsdp")


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(0)
    jx, px = _pair(rng.normal(size=(2, 16, 64)), dtype)
    jg, pg = _pair(rng.normal(size=(64,)), "float32")
    _close(pcommon.rms_norm(px, pg, 1e-5), jcommon.rms_norm(jx, jg, 1e-5),
           dtype)
    jx, px = _pair(rng.normal(size=(2, 16, 4, 16)), dtype)
    pos = np.arange(2040, 2056)[None]
    _close(pcommon.apply_rope(px, torch.from_numpy(pos), 1e4),
           jcommon.apply_rope(jx, jnp.asarray(pos), 1e4), dtype)
    want = 1.0 / 1e4 ** (np.arange(0, 64, 2, dtype=np.float32) / 64)
    np.testing.assert_allclose(_np(pcommon.rope_inv_freqs(64, 1e4)), want,
                               rtol=1e-6)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block(gated, dtype):
    rng = np.random.default_rng(1)
    w = [(0.1 * rng.normal(size=s)).astype(np.float32)
         for s in ((64, 128), (64, 128), (128, 64))]
    jp = jmlp.MLPParams(jnp.asarray(w[0]) if gated else None,
                        jnp.asarray(w[1]), jnp.asarray(w[2]))
    pp = pmlp.MlpParams(torch.from_numpy(w[0]) if gated else None,
                        torch.from_numpy(w[1]), torch.from_numpy(w[2]))
    jx, px = _pair(rng.normal(size=(2, 16, 64)), dtype)
    got, want = pmlp.mlp_block(pp, px), jmlp.mlp_block(jp, jx)
    _close(got, want, dtype)
    if dtype == "bfloat16":
        # SiLU rounded op by op as XLA lowers it: bit-exact here
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention(causal, window, dtype):
    """The reference's chunked full softmax against B6 (plain version)."""
    rng = np.random.default_rng(2)
    (jq, pq), (jk, pk), (jv, pv) = (
        _pair(rng.normal(size=(2, 40, h, 16)), dtype) for h in (4, 2, 2))
    _close(pattn.attention(pq, pk, pv, causal=causal, window=window),
           jattn.attention(jq, jk, jv, causal=causal, window=window), dtype)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(window, dtype):
    rng = np.random.default_rng(3)
    jq, pq = _pair(rng.normal(size=(2, 4, 16)), dtype)
    (jk, pk), (jv, pv) = (_pair(rng.normal(size=(2, 24, 2, 16)), dtype)
                          for _ in range(2))
    for n in (1, 17, 24):
        _close(pattn.decode_attention(pq, pk, pv, n, window=window),
               jattn.decode_attention(jq, jk, jv, jnp.int32(n),
                                      window=window), dtype)


def _attn_params(seed, d, hq, hkv, dh, bias):
    """The reference's init, with random biases when ``bias``."""
    jp = jattn.init_attn(jcommon.key_iter(jax.random.PRNGKey(seed)), d, hq,
                         hkv, dh, qkv_bias=bias)
    if bias:
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), 3)
        jp = jp._replace(**{n: 0.1 * jax.random.normal(k, getattr(jp, n).shape)
                            for n, k in zip(("bq", "bk", "bv"), keys)})
    pp = pattn.AttentionParams(*(None if a is None else torch.from_numpy(
        np.array(a)) for a in jp))
    return jp, pp


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_block_and_one_decode_step(bias, dtype):
    rng = np.random.default_rng(4)
    heads = (4, 2, 16)
    jp, pp = _attn_params(4, 64, *heads, bias)
    jx, px = _pair(rng.normal(size=(2, 24, 64)), dtype)
    jy, (jk, jv) = jattn.attn_block(jp, jx, cfg_heads=heads, rope_theta=1e4,
                                    return_kv=True)
    py, (pk, pv) = pattn.attn_block(pp, px, cfg_heads=heads, rope_theta=1e4,
                                    return_kv=True)
    for got, want in ((py, jy), (pk, jk), (pv, jv)):
        _close(got, want, dtype)
    # one decode step on the same cache: the ring buffer's slot 24 % 24 = 0
    jx1, px1 = _pair(rng.normal(size=(2, 64)), dtype)
    kv = [_pair(np.asarray(_np(t)), dtype) for t in (jk, jv)]
    jy1, jck, jcv = jattn.decode_attn_block(
        jp, jx1, kv[0][0], kv[1][0], jnp.int32(24), cfg_heads=heads,
        rope_theta=1e4)
    ck, cv = kv[0][1].clone(), kv[1][1].clone()
    py1, pck, pcv = pattn.decode_attn_block(
        pp, px1, ck, cv, 24, cfg_heads=heads, rope_theta=1e4)
    assert pck is ck and pcv is cv  # written in place
    for got, want in ((py1, jy1), (pck, jck), (pcv, jcv)):
        _close(got, want, dtype)
    assert torch.equal(pck[:, 1:], kv[0][1][:, 1:])  # only slot 0 changed


def test_write_cache_slot_is_a_ring_buffer():
    """Slot ``index mod capacity``, in place (the reference's
    ``attention.py:229-236``)."""
    rng = np.random.default_rng(5)
    cache = rng.normal(size=(2, 5, 2, 4)).astype(np.float32)
    new = rng.normal(size=(2, 2, 4)).astype(np.float32)
    for index in (0, 3, 5, 12):
        want = cache.copy()
        want[:, index % 5] = new
        got = torch.from_numpy(cache.copy())
        pattn.write_cache_slot(got, torch.from_numpy(new), index)
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the whole slice
# --------------------------------------------------------------------------

def _models(arch, **replace):
    jcfg = dataclasses.replace(jget_smoke(arch), **replace)
    pcfg = dataclasses.replace(pconfigs.get_smoke(arch), **replace)
    jfns, pfns = jregistry.build(jcfg), pregistry.build(pcfg)
    # jitted, the reference's prefill and decode give the bits they give
    # eagerly, and each step after the first skips the compile
    jfns = dataclasses.replace(jfns, prefill=jax.jit(jfns.prefill),
                               decode=jax.jit(jfns.decode))
    jparams = jfns.init(jax.random.PRNGKey(0))
    if jcfg.qkv_bias:  # the init's biases are zero: make them count
        a = jparams["layers"]["attn"]
        keys = jax.random.split(jax.random.PRNGKey(1), 3)
        jparams["layers"]["attn"] = a._replace(**{
            n: 0.1 * jax.random.normal(kk, getattr(a, n).shape)
            for n, kk in zip(("bq", "bk", "bv"), keys)})
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return jcfg, jfns, jparams, pfns, params


def _slice_close(got, want, what):
    tol = SLICE_ULPS * bf16_ulp(want)
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= tol, f"{what}: max abs err {err} > {tol}"
    return tol


def _greedy_agrees(plogits, jlogits, tol):
    want = _np(jlogits)
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * tol
    got = _np(plogits).argmax(-1)
    np.testing.assert_array_equal(got[sure], want.argmax(-1)[sure])


@pytest.mark.parametrize("arch", SLICE)
def test_prefill_and_four_decode_steps_match_jax(arch):
    jcfg, jfns, jparams, pfns, params = _models(arch)
    rng = np.random.default_rng(6)
    s = 24
    toks = rng.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
    jcache, jlogits = jfns.prefill(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        cache, logits = pfns.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert cache["k"].shape == (2, 2, s, 2, 16)  # (L, B, prompt, Hkv, dh)
    tol = _slice_close(logits, jlogits, "prefill logits")
    _greedy_agrees(logits, jlogits, tol)
    for name in ("k", "v"):
        _slice_close(cache[name], jcache[name], f"prefill cache {name}")
    # teacher-forced with the reference's tokens: steps 0-3 overwrite the
    # prompt's slots 0-3 of the ring buffer, at absolute positions 24-27
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for i in range(4):
        jlogits, jcache = jfns.decode(jparams, jcache, jnp.asarray(tok),
                                      jnp.int32(s + i))
        with torch.no_grad():
            logits, cache = pfns.decode(params, cache, torch.from_numpy(tok),
                                        s + i)
        tol = _slice_close(logits, jlogits, f"decode step {i} logits")
        _greedy_agrees(logits, jlogits, tol)
        for name in ("k", "v"):
            _slice_close(cache[name], jcache[name], f"step {i} cache {name}")
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


def test_decode_unroll_caches_match_stacked_and_jax():
    jcfg, jfns, jparams, pfns, params = _models("tinyllama-1.1b",
                                                decode_unroll=True)
    stacked = pregistry.build(pconfigs.get_smoke("tinyllama-1.1b"))
    toks = np.random.default_rng(7).integers(0, 256, (2, 16)).astype(np.int32)
    jcache, _ = jfns.prefill(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        cache, logits = pfns.prefill(params, {"tokens": torch.from_numpy(toks)})
        cache_s, logits_s = stacked.prefill(params,
                                            {"tokens": torch.from_numpy(toks)})
        assert isinstance(cache, tuple) and len(cache) == 2
        assert torch.equal(logits, logits_s)
        tok = torch.argmax(logits, -1).to(torch.int32)
        lg, cache = pfns.decode(params, cache, tok, 16)
        lg_s, cache_s = stacked.decode(params, cache_s, tok, 16)
    assert torch.equal(lg, lg_s)
    for i in range(2):
        assert torch.equal(cache[i]["k"], cache_s["k"][i])
    jlg, _ = jfns.decode(jparams, jcache, jnp.asarray(tok.numpy()),
                         jnp.int32(16))
    _slice_close(lg, jlg, "decode_unroll logits")


def test_serve_steps_greedy_and_sampled():
    cfg = pconfigs.get_smoke("tinyllama-1.1b")
    fns = pregistry.build(cfg)
    params = fns.init(0, device="cpu", dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (3, 12),
                           generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32)
    with torch.no_grad():
        cache, tok, logits = make_prefill_step(fns)(params,
                                                    {"tokens": tokens})
        assert tok.dtype == torch.int32
        assert torch.equal(tok, torch.argmax(logits, -1).to(torch.int32))
        greedy = make_serve_step(fns)
        sampled = make_serve_step(fns, temperature=1.0)
        draws = []
        for _ in range(2):
            c = plm.init_cache(cfg, 1, 3, 12, device="cpu")
            c["k"].copy_(cache["k"])
            c["v"].copy_(cache["v"])
            draws.append(sampled(params, c, tok, 12,
                                 torch.Generator().manual_seed(5))[0])
        nxt, _ = greedy(params, cache, tok, 12)
    assert torch.equal(draws[0], draws[1])  # the generator decides
    assert nxt.shape == (3,) and nxt.dtype == torch.int32


def test_compute_copy_serves_the_same_values():
    """bf16 params made layer by layer at init hold the masters' values cast
    once, and serve the same logits as the masters."""
    cfg = pconfigs.get_smoke("qwen2.5-14b")
    fns = pregistry.build(cfg)
    masters = fns.init(3, device="cpu")
    copy = fns.init(3, device="cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in leaves(copy))
    assert all(torch.equal(c, m.to(torch.bfloat16))
               for c, m in zip(leaves(copy), leaves(masters)))
    toks = {"tokens": torch.arange(10, dtype=torch.int32)[None] * 7}
    with torch.no_grad():
        _, a = fns.prefill(masters, toks)
        _, b = fns.prefill(copy, toks)
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# launchers
# --------------------------------------------------------------------------

def _run(argv):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_launcher.main(argv)
    return rc, buf.getvalue()


def test_token_serve_launcher_on_the_cpu():
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
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
    assert (rep["arch"], rep["requests"], rep["prompt"], rep["gen"]) == \
        ("tinyllama-1.1b-smoke", 2, 32, 4)
    assert np.array(rep["tokens"]).shape == (2, 4)
    assert rep["tokens"] == reports[1]["tokens"]  # greedy, seeded
    assert rep["flash_attn_launches"] == 0  # the CPU runs the plain version
    assert flash_attention_call.launches == before
    with pytest.raises(SystemExit, match=">= 1"):
        serve_launcher.main([*argv, "--gen-len", "0"])


def test_train_launcher_refuses_lm_archs():
    """The train launcher trains every LM family and LM QAT now
    (``tests/test_torch_lm_train_families.py``); an LM arch it refuses
    only for its shape (MoE tokens that are not whole routing groups),
    before any weight is made, and the int8 dots are no ``--quant``
    choice (ROADMAP.md §A 5)."""
    with pytest.raises(SystemExit, match="routing groups"):
        train_launcher.main(["--arch", "deepseek-moe-16b", "--batch", "1",
                             "--seq", "300", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train_launcher.main(["--arch", "tinyllama-1.1b", "--quant",
                             "int8-hlo", "--device", "cpu"])
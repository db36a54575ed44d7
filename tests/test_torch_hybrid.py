"""Port parity: the SSM (mamba2) and hybrid (hymba) LM families —
``configs``, ``models/lm`` with ``models/ssm``, ``convert``, the token
launcher — against the JAX package on identical numpy inputs; the
reference's params cross over with ``convert.lm_params_from_numpy``, its
prefill and decode run jitted, attention runs B6's plain version here.

The smoke hybrid has 2 layers at ``global_layer_every`` 2, so both attend
globally; the hybrid cases also run 4 layers (flags T, F, T, T), whose
layer 1 attends within the smoke window of 8.  Prompts of 20 tokens (20
mod 8 != 0: the ring is rotated) and of 5 (shorter than the window and the
SSM chunk).

Tolerances, prefill and 4 teacher-forced decode steps: the two frameworks
round bf16 dots at other places, and the reference's full softmax rounds
its probabilities where B6's online softmax does not, so a hybrid block
on equal inputs moves ~1 bf16 ulp (6-12% of its elements) and the
differences add up along the residual stream (at most 4.5 ulps of the
logits measured over these cases, 4 layers).
* logits within ``ULPS`` = 6 bf16 ulps of their largest magnitude; greedy
  tokens equal wherever the reference's top-2 margin exceeds twice that;
* the ring-aligned K and V, slot for slot, and the conv tails within
  ``ULPS`` bf16 ulps of their largest magnitude;
* the f32 SSM state within ``STATE_RTOL`` = 5e-2 of its largest magnitude
  (it is linear in the mixer's bf16 inputs; at most 2.2e-2 measured).
The mixer alone runs bit for bit on equal inputs: ``test_torch_ssm.py``.
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
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro_torch import configs as pconfigs
from repro_torch.analysis.roofline import ssd_flops
from repro_torch.configs import base as pbase
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attn.kernel import flash_attention_call
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import lm as plm
from repro_torch.models import registry as pregistry
from repro_torch.models import ssm as pssm
from repro_torch.tree import leaves

ARCHS = ["mamba2-1.3b", "hymba-1.5b"]
ULPS = 6
STATE_RTOL = 5e-2
TAILS = ("conv_x", "conv_B", "conv_C")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_ulp(x) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(_np(x)).max())) - 7)


def _ulps_close(got, want, what, ulps=ULPS):
    tol = ulps * bf16_ulp(want)
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= tol, f"{what}: max abs err {err} > {tol}"
    return tol


def _scaled_close(got, want, rtol, what):
    want = _np(want)
    err = np.abs(_np(got) - want).max()
    assert err <= rtol * np.abs(want).max(), \
        f"{what}: {err} > {rtol} x {np.abs(want).max()}"


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_ff", "vocab_size", "head_dim", "qkv_bias", "gated_mlp",
          "rope_theta", "norm_eps", "swa_window", "quant", "ssm_state",
          "ssm_expand", "ssm_head_dim", "ssm_chunk", "global_layer_every",
          "d_inner", "n_ssm_heads")


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_configs_match_jax(arch):
    """Field for field and in count; the port ties mamba2-1.3b's head to
    its embedding as the published model does (the reference keeps a head
    of its own: one (V, d) table more), and its smoke models untie it."""
    for get, jget in ((pconfigs.get_config, jget_config),
                      (pconfigs.get_smoke, jget_smoke)):
        p, j = get(arch), jget(arch)
        assert [getattr(p, f) for f in FIELDS] == \
            [getattr(j, f) for f in FIELDS]
        assert p.padded_heads(1) == j.padded_heads(1)
        tied = p.vocab_size * p.d_model if p.tie_embeddings else 0
        assert pbase.param_count(p) == jbase.param_count(j) - tied
        assert pbase.active_param_count(p) == \
            jbase.active_param_count(j) - tied
        untied = dataclasses.replace(p, tie_embeddings=False)
        assert pbase.param_count(untied) == jbase.param_count(j)
    assert pconfigs.get_config(arch).tie_embeddings == (arch == "mamba2-1.3b")
    assert not pconfigs.get_smoke(arch).tie_embeddings


def test_full_size_counts_and_refusals():
    mamba, hymba = (pconfigs.get_config(a) for a in ARCHS)
    assert (mamba.n_heads, mamba.d_ff, mamba.n_ssm_heads) == (0, 0, 64)
    assert (hymba.n_ssm_heads, hymba.d_inner) == (50, 3200)
    # tied head: 48 x 25.9 M + the 103 M embedding (untied 1,445,768,192)
    assert pbase.param_count(mamba) == 1_342_794_752
    assert pbase.param_count(hymba) == 1_640_355_200
    with pytest.raises(ValueError, match="positive ssm_state"):
        dataclasses.replace(mamba, ssm_state=0).validate()
    with pytest.raises(ValueError, match="positive ssm_state"):
        dataclasses.replace(hymba, ssm_state=0).validate()
    with pytest.raises(ValueError, match="positive heads and d_ff"):
        dataclasses.replace(hymba, d_ff=0).validate()
    with pytest.raises(ValueError, match="group over"):
        dataclasses.replace(hymba, n_kv_heads=4).validate()


def test_ssd_flops_count_the_scans_products():
    """mamba2-1.3b at 8 x 2,048 tokens: per layer and chunk of 256, C B^T
    and its product with x on the 32,896 causal pairs, the end state's and
    the outputs' (256 x 64 x 64 x 128) products."""
    mamba, hymba = (pconfigs.get_config(a) for a in ARCHS)
    pairs = 256 * 257 // 2
    chunk = 2 * pairs * 128 + 2 * pairs * 64 * 64 + 4 * 256 * 64 * 64 * 128
    assert ssd_flops(mamba, 8, 2048) == 48 * 8 * 8 * chunk
    assert ssd_flops(hymba, 1, 100) == 32 * (
        2 * 5050 * 16 + 2 * 5050 * 50 * 64 + 4 * 100 * 50 * 64 * 16)
    assert ssd_flops(mamba, 8, 1) == 48 * 8 * (2 * 128 + 2 * 64 * 64
                                               + 4 * 64 * 64 * 128)
    assert ssd_flops(pconfigs.get_config("tinyllama-1.1b"), 8, 2048) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_is_the_tensors_count(arch):
    """The model's tensors hold ``param_count`` (the reference's count) and
    the conv taps it leaves out, less the SSM layer's second RMSNorm gain
    it counts and the layer lacks."""
    cfg = pconfigs.get_smoke(arch)
    n = sum(t.numel() for t in leaves(
        pregistry.build(cfg).init(0, device="cpu")))
    taps = cfg.n_layers * pssm.CONV_TAPS * (cfg.d_inner + 2 * cfg.ssm_state)
    norm = cfg.n_layers * cfg.d_model if cfg.family == "ssm" else 0
    assert n == pbase.param_count(cfg) + taps - norm


@pytest.mark.parametrize("arch,layers", [("hymba-1.5b", None),
                                         ("hymba-1.5b", 4),
                                         ("hymba-1.5b", 32),
                                         ("mamba2-1.3b", None)])
def test_global_flags_match_jax(arch, layers):
    kw = {} if layers is None else {"n_layers": layers}
    get = jget_config if layers == 32 else jget_smoke
    pget = pconfigs.get_config if layers == 32 else pconfigs.get_smoke
    flags = plm.global_flags(dataclasses.replace(pget(arch), **kw))
    assert flags == [bool(f) for f in jlm._global_flags(
        dataclasses.replace(get(arch), **kw))]
    if layers == 32:
        assert [i for i, g in enumerate(flags) if g] == [0, 16, 31]


# --------------------------------------------------------------------------
# the two families end to end
# --------------------------------------------------------------------------

def _models(arch, n_layers=None):
    kw = {} if n_layers is None else {"n_layers": n_layers}
    jcfg = dataclasses.replace(jget_smoke(arch), **kw)
    pcfg = dataclasses.replace(pconfigs.get_smoke(arch), **kw)
    jfns, pfns = jregistry.build(jcfg), pregistry.build(pcfg)
    jfns = dataclasses.replace(jfns, prefill=jax.jit(jfns.prefill),
                               decode=jax.jit(jfns.decode))
    jparams = jfns.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return jcfg, jfns, jparams, pfns, params


def _layer_caches(cfg, cache):
    """The reference's cache as a list of per-layer (kv dict or None,
    SSMCache)."""
    if cfg.family == "ssm":
        return [(None, jax.tree.map(lambda x, i=i: x[i], cache))
                for i in range(cfg.n_layers)]
    return [({"k": c["k"], "v": c["v"]}, c["ssm"]) for c in cache]


def _hold_caches(cfg, cache, jcache, what):
    for i, (jkv, jssm) in enumerate(_layer_caches(cfg, jcache)):
        mixer = cache[i] if cfg.family == "ssm" else cache[i]["ssm"]
        assert isinstance(mixer, pssm.Mamba2Cache)
        _scaled_close(mixer.state, jssm.state, STATE_RTOL,
                      f"{what} layer {i} state")
        for f in TAILS:
            got, want = getattr(mixer, f), getattr(jssm, f)
            assert got.shape == want.shape and got.dtype == torch.bfloat16
            _ulps_close(got, want, f"{what} layer {i} {f}")
        if jkv is not None:
            for name in ("k", "v"):
                got = cache[i][name]
                assert got.shape == jkv[name].shape
                _ulps_close(got, jkv[name], f"{what} layer {i} {name}")


def _greedy_agrees(plogits, jlogits, tol):
    want = _np(jlogits)
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(_np(plogits).argmax(-1)[sure],
                                  want.argmax(-1)[sure])


CASES = [("mamba2-1.3b", None, 20), ("mamba2-1.3b", None, 5),
         ("hymba-1.5b", None, 20), ("hymba-1.5b", None, 5),
         ("hymba-1.5b", 4, 20), ("hymba-1.5b", 4, 5)]


@pytest.mark.parametrize("arch,n_layers,s", CASES)
def test_prefill_and_four_decode_steps_match_jax(arch, n_layers, s):
    jcfg, jfns, jparams, pfns, params = _models(arch, n_layers)
    toks = np.random.default_rng(s).integers(
        0, jcfg.vocab_size, (2, s)).astype(np.int32)
    jcache, jlogits = jfns.prefill(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        cache, logits = pfns.prefill(params,
                                     {"tokens": torch.from_numpy(toks)})
    assert isinstance(cache, tuple) and len(cache) == jcfg.n_layers
    if jcfg.family == "hybrid":
        caps = [c["k"].shape[1] for c in cache]
        assert caps == [s if g else min(8, s)
                        for g in plm.global_flags(pfns.cfg)]
    tol = _ulps_close(logits, jlogits, "prefill logits")
    _greedy_agrees(logits, jlogits, tol)
    _hold_caches(jcfg, cache, jcache, "prefill")
    # teacher-forced with the reference's tokens; decode writes in place
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for i in range(4):
        jlogits, jcache = jfns.decode(jparams, jcache, jnp.asarray(tok),
                                      jnp.int32(s + i))
        with torch.no_grad():
            logits, cache2 = pfns.decode(params, cache,
                                         torch.from_numpy(tok), s + i)
        assert cache2 is cache
        tol = _ulps_close(logits, jlogits, f"decode step {i} logits")
        _greedy_agrees(logits, jlogits, tol)
        _hold_caches(jcfg, cache, jcache, f"step {i}")
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


@pytest.mark.parametrize("arch,n_layers", [("mamba2-1.3b", None),
                                           ("hymba-1.5b", 4)])
def test_init_cache_has_the_reference_shapes(arch, n_layers):
    kw = {} if n_layers is None else {"n_layers": n_layers}
    jcfg = dataclasses.replace(jget_smoke(arch), **kw)
    pcfg = dataclasses.replace(pconfigs.get_smoke(arch), **kw)
    for seq in (20, 5):
        want = jregistry.build(jcfg).init_cache(2, seq)
        got = pregistry.build(pcfg).init_cache(2, seq, device="cpu")
        for (jkv, jm), layer in zip(_layer_caches(jcfg, want), got):
            mixer = layer if jkv is None else layer["ssm"]
            assert [tuple(t.shape) for t in mixer] == \
                [tuple(t.shape) for t in jm]
            assert [t.dtype for t in mixer] == [torch.float32] + \
                [torch.bfloat16] * 3
            if jkv is not None:
                assert layer["k"].shape == jkv["k"].shape
                assert not any(t.any() for t in leaves(layer))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_copy_keeps_the_mixers_f32_params(arch):
    cfg = pconfigs.get_smoke(arch)
    fns = pregistry.build(cfg)
    masters = fns.init(3, device="cpu")
    copy = fns.init(3, device="cpu", dtype=torch.bfloat16)
    for lc, lm_ in zip(copy["layers"], masters["layers"]):
        for f in pssm.Mamba2Params._fields:
            got, want = getattr(lc["ssm"], f), getattr(lm_["ssm"], f)
            if f in pssm.FP32_FIELDS:
                assert got.dtype == torch.float32 and torch.equal(got, want)
            else:
                assert torch.equal(got, want.to(torch.bfloat16))
    toks = {"tokens": torch.arange(12, dtype=torch.int32)[None] * 7}
    with torch.no_grad():
        _, a = fns.prefill(masters, toks)
        _, b = fns.prefill(copy, toks)
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_launcher.main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("arch", ARCHS)
def test_token_serve_launcher_on_the_cpu(arch):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
            "--prompt-len", "32", "--gen-len", "4"]
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
        (f"{arch}-smoke", 2, 32, 4)
    assert np.array(rep["tokens"]).shape == (2, 4)
    assert rep["tokens"] == reports[1]["tokens"]  # greedy, seeded
    assert rep["flash_attn_launches"] == 0  # the CPU runs the plain version
    assert flash_attention_call.launches == before

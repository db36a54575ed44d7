"""Port parity: the VLM family (llava-next-34b) — ``configs``, the prefix
embeddings of ``models/lm``, ``convert``, the token launcher — against the
JAX package on identical numpy inputs; the reference's params cross over
with ``convert.lm_params_from_numpy``, its prefill and decode run jitted;
attention runs B6's plain version here.

A VLM layer is a dense layer.  The prompt's first ``n_prefix_embeds``
positions take the precomputed patch embeddings (the vision tower is a
stub, as in the reference), so a prompt shorter than them is refused.

Tolerances, those of ``tests/test_torch_lm.py``: the prefix overwrite bit
for bit (a gather and a cast); through the whole model (smoke config,
prefill and 4 teacher-forced decode steps) logits and caches within
``SLICE_ULPS`` = 2 bf16 ulps of their largest magnitude (at most 1
measured over these cases); greedy tokens equal wherever the reference's
top-2 margin exceeds twice that.
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
from repro_torch.configs import base as pbase
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attn.kernel import flash_attention_call
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import lm as plm
from repro_torch.models import registry as pregistry
from repro_torch.tree import leaves

ARCH = "llava-next-34b"
SLICE_ULPS = 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_ulp(x) -> float:
    """The spacing of bf16 numbers at ``max |x|``."""
    return 2.0 ** (np.floor(np.log2(np.abs(_np(x)).max())) - 7)


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


def test_vlm_config_matches_jax():
    for get, jget in ((pconfigs.get_config, jget_config),
                      (pconfigs.get_smoke, jget_smoke)):
        p, j = get(ARCH), jget(ARCH)
        assert [getattr(p, f) for f in FIELDS] == \
            [getattr(j, f) for f in FIELDS]
        assert p.padded_heads(1) == j.padded_heads(1)
        assert pbase.param_count(p) == jbase.param_count(j)
        assert pbase.active_param_count(p) == jbase.active_param_count(j)
    assert pconfigs.get_smoke(ARCH).n_prefix_embeds == 8


def test_full_size_counts():
    """llava-next-34b: group 7 (56 query heads over 8 kv heads) at dh 128;
    34.39 B params, 64.05 GiB in bf16, 1.04 GiB a layer."""
    cfg = pconfigs.get_config(ARCH)
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim) == (7, 128)
    n = pbase.param_count(cfg)
    assert n == 34_388_917_248
    per_layer = (n - 2 * cfg.vocab_size * cfg.d_model - cfg.d_model) \
        // cfg.n_layers
    assert round(2 * per_layer / 2**30, 2) == 1.04
    smoke = pconfigs.get_smoke(ARCH)
    params = pregistry.build(smoke).init(0, device="cpu")
    assert sum(t.numel() for t in leaves(params)) == pbase.param_count(smoke)


# --------------------------------------------------------------------------
# the prefix embeddings
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s", [8, 20])
def test_prefix_overwrites_the_first_positions(s):
    """The prefix, cast to bf16, in place of the first P token embeddings,
    bit for bit as the reference's ``dynamic_update_slice``; the rest are
    the tokens'."""
    jcfg = jget_smoke(ARCH)
    rng = np.random.default_rng(12)
    embed = rng.normal(size=(256, 64)).astype(np.float32)
    toks = rng.integers(0, 256, (2, s)).astype(np.int32)
    prefix = (0.02 * rng.normal(size=(2, 8, 64))).astype(np.float32)
    want = jlm._embed(jcfg, {"embed": jnp.asarray(embed)}, jnp.asarray(toks),
                      jnp.asarray(prefix))
    got = plm._embed({"embed": torch.from_numpy(embed)},
                     torch.from_numpy(toks), torch.from_numpy(prefix))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(got[:, :8]), _np(torch.from_numpy(prefix).to(torch.bfloat16)))
    np.testing.assert_array_equal(
        _np(got[:, 8:]), _np(torch.from_numpy(embed[toks[:, 8:]]).to(
            torch.bfloat16)))


def test_a_prompt_shorter_than_the_prefix_is_refused(monkeypatch):
    """In the model, and in the launcher before any weight is made (even
    asking for a card this host lacks)."""
    cfg = pconfigs.get_smoke(ARCH)
    fns = pregistry.build(cfg)
    params = fns.init(0, device="cpu")
    batch = {"tokens": torch.zeros((1, 7), dtype=torch.int32),
             "prefix_embeds": torch.zeros((1, 8, 64))}
    with pytest.raises(ValueError, match="shorter than its 8 prefix"):
        fns.prefill(params, batch)
    monkeypatch.setattr(plm, "init_params", lambda *a, **k: pytest.fail(
        "weights made before the refusal"))
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="at least 8 tokens"):
            serve_launcher.main(["--arch", ARCH, "--smoke", "--device",
                                 device, "--prompt-len", "4"])


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


def _greedy_agrees(plogits, jlogits, tol):
    want = _np(jlogits)
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(_np(plogits).argmax(-1)[sure],
                                  want.argmax(-1)[sure])


@pytest.mark.parametrize("s", [24, 8])  # 8: the prompt is all prefix
def test_prefill_and_four_decode_steps_match_jax(s):
    jcfg, jfns, jparams, pfns, params = _models()
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
    prefix = (0.02 * rng.normal(size=(2, 8, 64))).astype(np.float32)
    jcache, jlogits = jfns.prefill(jparams, {
        "tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(prefix)})
    with torch.no_grad():
        cache, logits = pfns.prefill(params, {
            "tokens": torch.from_numpy(toks),
            "prefix_embeds": torch.from_numpy(prefix)})
    assert cache["k"].shape == (2, 2, s, 2, 16)  # (L, B, prompt, Hkv, dh)
    tol = _slice_close(logits, jlogits, "prefill logits")
    _greedy_agrees(logits, jlogits, tol)
    for name in ("k", "v"):
        _slice_close(cache[name], jcache[name], f"prefill cache {name}")
    # decode takes no prefix: teacher-forced with the reference's tokens
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


def test_the_prefix_changes_the_logits():
    """Without ``prefix_embeds`` the VLM serves as a dense LM (as the
    reference's ``lm_prefill`` does); with it, the prefix reaches the last
    token's logits."""
    cfg = pconfigs.get_smoke(ARCH)
    fns = pregistry.build(cfg)
    params = fns.init(0, device="cpu", dtype=torch.bfloat16)
    toks = torch.arange(12, dtype=torch.int32)[None] * 5
    prefix = torch.full((1, 8, 64), 0.5, dtype=torch.bfloat16)
    with torch.no_grad():
        _, plain = fns.prefill(params, {"tokens": toks})
        _, dense = pregistry.build(dataclasses.replace(
            cfg, family="dense", n_prefix_embeds=0)).prefill(
                params, {"tokens": toks})
        _, seen = fns.prefill(params, {"tokens": toks,
                                       "prefix_embeds": prefix})
    assert torch.equal(plain, dense)
    assert not torch.equal(plain, seen)


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
            "--prompt-len", "16", "--gen-len", "4"]
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
        (f"{ARCH}-smoke", 2, 16, 4)
    assert np.array(rep["tokens"]).shape == (2, 4)
    assert rep["tokens"] == reports[1]["tokens"]  # greedy, seeded
    assert rep["flash_attn_launches"] == 0  # the CPU runs the plain version
    assert flash_attention_call.launches == before
    gen = torch.Generator().manual_seed(1)
    batch = serve_launcher.token_batch(pconfigs.get_smoke(ARCH), 2, 16, gen,
                                       torch.device("cpu"))
    assert batch["prefix_embeds"].shape == (2, 8, 64)
    assert batch["prefix_embeds"].dtype == torch.bfloat16

"""Port parity: the mamba2 mixer (``models/ssm``) against the JAX package's
``repro.models.ssm`` on identical numpy inputs, the JAX functions run
eagerly on the CPU as the reference's own tests run them.

Tolerances:
* ``ssd_chunked`` (f32): rtol 2e-5, atol 2e-5 — the chunk's products and
  the cumulative sum add in PyTorch's order, not XLA's.
* softplus (f32): rtol 3e-7 (two f32 ulps: ``exp`` and ``log1p`` are
  libraries' own approximations on each side), atol 1e-37 (XLA flushes
  subnormal results to 0).
* ``ssm_block`` and ``ssm_decode_step`` in bf16: the outputs and the conv
  tails bit for bit (the bf16 roundings run in the reference's order), the
  f32 state within rtol 1e-5 of its largest magnitude.  In f32: outputs
  and state within rtol 1e-5 of their largest magnitude; one decode step
  (the reference keeps an f32 model's conv tail in f32 after it, the port
  in bf16 in place).
* Port only: mamba2 prefill of L tokens then k decode steps against the
  prefill of L + k tokens, last-token logits within ``PREFIX_ULPS`` bf16
  ulps of their largest magnitude (the decode step's conv sums in f32 and
  its recurrence runs token by token; the prefill sums the conv in bf16 and
  scans by chunks).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from _hypothesis_fallback import given, settings, strategies as st

from repro.models import ssm as jssm
from repro.models.common import key_iter
from repro_torch import configs as pconfigs
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import registry as pregistry
from repro_torch.models import ssm as pssm

F32 = dict(rtol=2e-5, atol=2e-5)
PREFIX_ULPS = 4
D, DI, N, H, P = 32, 64, 8, 4, 16  # d_model, d_inner, state, heads, head dim


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(arr, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``,
    rounded once for both."""
    j = jnp.asarray(arr).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _scaled_close(got, want, rtol=1e-5):
    """Within ``rtol`` of ``want``'s largest magnitude."""
    want = _np(want)
    err = np.abs(_np(got) - want).max()
    assert err <= rtol * np.abs(want).max(), err


def _ssd_inputs(seed, b, length, h, p, n, *, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, length, h, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(
        rng.normal(size=(b, length, h)).astype(np.float32)))) * dt_scale
    a = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    bm, cm = (rng.normal(size=(b, length, n)).astype(np.float32)
              for _ in range(2))
    return x, dt.astype(np.float32), a, bm, cm


def _ssd_both(inputs, chunk):
    want = jssm.ssd_chunked(*(jnp.asarray(t) for t in inputs), chunk)
    got = pssm.ssd_chunked(*(torch.from_numpy(t) for t in inputs), chunk)
    return got, want


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax(chunk):
    (y, h), (jy, jh) = _ssd_both(_ssd_inputs(0, 2, 32, 3, 4, 5), chunk)
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    np.testing.assert_allclose(_np(h), _np(jh), **F32)


@settings(max_examples=10, deadline=None)
@given(length=st.integers(2, 40), chunk=st.sampled_from([4, 8, 16]),
       seed=st.integers(0, 2**16))
def test_property_ssd_any_length(length, chunk, seed):
    if length % chunk and length > chunk:  # as ssm_block pads it
        length += chunk - length % chunk
    (y, h), (jy, jh) = _ssd_both(_ssd_inputs(seed, 1, length, 2, 3, 4),
                                 chunk)
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    np.testing.assert_allclose(_np(h), _np(jh), **F32)


def test_ssd_overflowing_decay_stays_finite():
    """dt * A summed over a chunk reaches -1e3: exp(cum_q - cum_k) above
    the diagonal is inf in f32, and the reference selects it away; a 0/1
    mask multiply there would give inf * 0 = NaN."""
    x, dt, a, bm, cm = _ssd_inputs(1, 2, 16, 3, 4, 5, dt_scale=60.0)
    a = np.full_like(a, -16.0)
    cum = np.cumsum(dt.reshape(2, 2, 8, 3) * a, axis=2)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[:, :, 0] - cum[:, :, -1])).any()
    (y, h), (jy, jh) = _ssd_both((x, dt, a, bm, cm), 8)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    np.testing.assert_allclose(_np(h), _np(jh), **F32)


def test_causal_conv_and_softplus():
    rng = np.random.default_rng(2)
    jx, px = _pair(rng.normal(size=(2, 20, 32)), "bfloat16")
    jw, pw = _pair(0.1 * rng.normal(size=(pssm.CONV_TAPS, 32)), "bfloat16")
    # four bf16 products summed in bf16, in order from 0: bit for bit
    np.testing.assert_array_equal(_np(pssm._causal_conv(px, pw)),
                                  _np(jssm._causal_conv(jx, jw)))
    x = np.concatenate([10 * rng.normal(size=4000),
                        np.linspace(-100, 100, 2001)]).astype(np.float32)
    got = pssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(
        jnp.asarray(x))), rtol=3e-7, atol=1e-37)
    # logaddexp(x, 0) keeps log1p(exp(-x)) where F.softplus returns x
    assert float(pssm.softplus(torch.tensor(15.5))) == float(
        jax.nn.softplus(jnp.float32(15.5)))


def _mixer_params(seed):
    """The reference's init with dt_bias, A_log and D drawn at random, so
    every term of the mixer counts."""
    jp = jssm.init_ssm(key_iter(jax.random.PRNGKey(seed)), D, DI, N, H)
    rng = np.random.default_rng(seed)
    jp = jp._replace(dt_bias=jnp.asarray(rng.normal(size=H) - 2.0,
                                         jnp.float32),
                     A_log=jnp.asarray(rng.normal(size=H), jnp.float32),
                     D=jnp.asarray(rng.normal(size=H), jnp.float32))
    return jp, pssm.Mamba2Params(*(torch.from_numpy(np.array(t))
                                   for t in jp))


KW = dict(n_heads=H, head_dim=P, n_state=N)


def _hold(got, want, dtype):
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        _scaled_close(got, want)


@pytest.mark.parametrize("length", [5, 16, 20])  # < chunk, = 2, ragged
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_and_decode_steps(length, dtype):
    jp, pp = _mixer_params(3)
    rng = np.random.default_rng(length)
    ju, pu = _pair(rng.normal(size=(2, length, D)), dtype)
    jy, jc = jssm.ssm_block(jp, ju, chunk=8, return_cache=True, **KW)
    py, pc = pssm.ssm_block(pp, pu, chunk=8, return_cache=True, **KW)
    _hold(py, jy, dtype)
    assert pc.state.dtype == torch.float32
    _scaled_close(pc.state, jc.state)
    for f in ("conv_x", "conv_B", "conv_C"):  # from the unpadded projections
        got = getattr(pc, f)
        assert got.dtype == torch.bfloat16 and got.shape[1] == 3
        np.testing.assert_array_equal(_np(got), _np(getattr(jc, f)))
    np.testing.assert_array_equal(_np(pssm.ssm_block(pp, pu, chunk=8, **KW)),
                                  _np(py))
    # decode continues from the cache, updating it in place
    steps = 3 if dtype == "bfloat16" else 1
    for _ in range(steps):
        ju1, pu1 = _pair(rng.normal(size=(2, D)), dtype)
        jy1, jc = jssm.ssm_decode_step(jp, jc, ju1, **KW)
        state = pc.state
        py1, pc2 = pssm.ssm_decode_step(pp, pc, pu1, **KW)
        assert pc2 is pc and pc.state is state
        _hold(py1, jy1, dtype)
        _scaled_close(pc.state, jc.state)
        for f in ("conv_x", "conv_B", "conv_C"):
            np.testing.assert_array_equal(
                _np(getattr(pc, f)), _np(getattr(jc, f).astype(jnp.bfloat16)))


def test_padding_leaves_the_final_state_alone():
    """A prompt padded to a chunk multiple (dt = 0 on the pad) ends in the
    state of the same prompt scanned as one chunk."""
    jp, pp = _mixer_params(4)
    u = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 13, D)).astype(np.float32))
    _, padded = pssm.ssm_block(pp, u, chunk=8, return_cache=True, **KW)
    _, whole = pssm.ssm_block(pp, u, chunk=16, return_cache=True, **KW)
    _scaled_close(padded.state, whole.state)


@pytest.mark.parametrize("length", [1, 2])
def test_prompts_shorter_than_the_conv_tail_are_refused(length):
    _, pp = _mixer_params(6)
    u = torch.zeros((1, length, D))
    with pytest.raises(ValueError, match="at least 3 tokens"):
        pssm.ssm_block(pp, u, chunk=8, return_cache=True, **KW)
    assert pssm.ssm_block(pp, u, chunk=8, **KW).shape == u.shape
    fns = pregistry.build(pconfigs.get_smoke("mamba2-1.3b"))
    params = fns.init(0, device="cpu")
    with pytest.raises(ValueError, match="at least 3 tokens"):
        fns.prefill(params, {"tokens": torch.zeros((1, length),
                                                   dtype=torch.int32)})
    with pytest.raises(ValueError, match="at least 3 tokens"):
        serve_launcher.main(["--arch", "hymba-1.5b", "--smoke", "--device",
                             "cpu", "--prompt-len", str(length)])


def test_prefill_then_decode_equals_the_longer_prefill():
    fns = pregistry.build(pconfigs.get_smoke("mamba2-1.3b"))
    params = fns.init(0, device="cpu", dtype=torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, 24)).astype(np.int32))
    with torch.no_grad():
        cache, _ = fns.prefill(params, {"tokens": toks[:, :20]})
        for i in range(4):
            logits, cache = fns.decode(params, cache, toks[:, 20 + i], 20 + i)
            _, want = fns.prefill(params, {"tokens": toks[:, :21 + i]})
            ulp = 2.0 ** (np.floor(np.log2(_np(want).__abs__().max())) - 7)
            assert np.abs(_np(logits) - _np(want)).max() <= PREFIX_ULPS * ulp


# --------------------------------------------------------------------------
# the scan's gradient (the training form, ROADMAP.md §C 2)
# --------------------------------------------------------------------------

def _ssd_in_place(x, dt, A, Bmat, Cmat, chunk):
    """The scan as it was written before it became differentiable: the
    intra-chunk decay multiplied and masked in place after ``exp``."""
    b, length, h, p = x.shape
    n = Bmat.shape[-1]
    nc = max(length // chunk, 1)
    q = length // nc
    xr, dtr = x.reshape(b, nc, q, h, p), dt.reshape(b, nc, q, h)
    br, cr = Bmat.reshape(b, nc, q, n), Cmat.reshape(b, nc, q, n)
    cum = torch.cumsum(dtr * A, dim=2)
    cum_h = cum.transpose(2, 3)
    cb = torch.matmul(cr, br.transpose(2, 3))
    m = torch.exp(cum_h[..., :, None] - cum_h[..., None, :])
    m.mul_(cb[:, :, None]).mul_(dtr.transpose(2, 3)[:, :, :, None, :])
    m.masked_fill_(torch.ones((q, q), dtype=torch.bool).triu(1), 0.0)
    y = torch.matmul(m, xr.transpose(2, 3)).transpose(2, 3)
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dtr
    s_chunk = torch.einsum("bcqhp,bcqn->bchpn", xr * w_end[..., None], br)
    decay = torch.exp(cum[:, :, -1])
    state = torch.zeros((b, h, p, n))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = decay[:, c, :, None, None] * state + s_chunk[:, c]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cr, torch.stack(entering, 1))
    y = y + y_inter * torch.exp(cum)[..., None]
    return y.reshape(b, length, h, p), state


@pytest.mark.parametrize("dt_scale,a_value", [(1.0, None), (30.0, -10.0)])
def test_ssd_forward_is_the_in_place_forms_bit_for_bit(dt_scale, a_value):
    """The out-of-place form gives the in-place form's values exactly, also
    where the decay above the diagonal overflows (dt 30, A -10)."""
    x, dt, a, bm, cm = _ssd_inputs(5, 2, 32, 2, 8, 4, dt_scale=dt_scale)
    if a_value is not None:
        a = np.full_like(a, a_value)
    ts = [torch.from_numpy(t) for t in (x, dt, a, bm, cm)]
    y, s = pssm.ssd_chunked(*ts, 8)
    y0, s0 = _ssd_in_place(*ts, 8)
    assert torch.equal(y, y0) and torch.equal(s, s0)
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("dt_scale,a_value", [(0.3, -0.5), (30.0, -10.0)])
def test_ssd_gradients_match_jax_where_finite(dt_scale, a_value):
    """Gradients of ``sum(y * gy) + sum(state * gs)`` with respect to x, dt,
    A, B and C against ``jax.grad`` of the reference's scan (rtol 1e-4,
    atol 1e-4 of each gradient's largest magnitude: the products and the
    cumulative sum add in other orders, and the gradient sums them again)
    where the reference's are finite; where it overflows (dt 30, A -10:
    its exponent above the diagonal is inf, masked only after ``exp``, and
    0 * inf is NaN) the port's stay finite."""
    x, dt, a, bm, cm = _ssd_inputs(6, 1, 16, 2, 4, 4)
    dt = (dt * 0 + dt_scale).astype(np.float32)
    a = np.full_like(a, a_value)
    rng = np.random.default_rng(7)
    gy = rng.normal(size=x.shape).astype(np.float32)
    gs = rng.normal(size=(1, 2, 4, 4)).astype(np.float32)

    def jloss(*args):
        y, s = jssm.ssd_chunked(*args, 8)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    ts = [torch.from_numpy(t).requires_grad_(True)
          for t in (x, dt, a, bm, cm)]
    y, s = pssm.ssd_chunked(*ts, 8)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                              + (s * torch.from_numpy(gs)).sum(), ts)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        ok = np.isfinite(w)
        scale = np.abs(w[ok]).max() if ok.any() else 1.0
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-4,
                                   atol=1e-4 * scale)
    # the reference's gradient is NaN exactly in the overflowing case
    ref_finite = all(np.isfinite(np.asarray(w)).all() for w in want)
    assert ref_finite == (dt_scale < 1)

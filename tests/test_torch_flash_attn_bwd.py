"""Port parity: B6-bwd's plain version (``ref.flash_attention_bwd_plain``)
and B6's per-row log-sum-exp on the CPU, and the autograd Function
(``ops.FlashAttention``) that pairs them with B6, against autograd through
B6's plain forward and against ``jax.vjp`` of the reference's attention
(its naive oracle ``repro.kernels.flash_attn.ref.ref_attention`` and the
chunked ``repro.models.attention.attention`` that the reference trains
through), on identical numpy inputs.

Tolerances:
* float32: rtol 1e-5, atol 1e-5 against autograd through the plain
  forward (the same gradient, sums in other f32 orders: where dP and D
  cancel, as on a row of one kept key whose exact gradient is 0, each
  carries a few f32 ulps of ``sum |dout| |v|``); rtol 2e-4, atol
  2e-5 against ``jax.vjp`` (the forward's own tolerance against the
  reference, ``test_torch_flash_attn.py``, which the gradients inherit).
* bf16: the plain backward rounds P and dS to bf16 as the kernel does; it
  lies within ``ref.bwd_bounds`` (the most those roundings and f32 orders
  can move each element) of an f64 run of the same formulas without the
  roundings, and within 2 bf16 ulps of each leaf's largest magnitude of
  autograd through the plain forward (which rounds p and the forward's
  dP at other places).
* The Function on CPU tensors: bit for bit the plain backward's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ref import ref_attention
from repro.models import attention as jattn
from repro_torch.kernels.flash_attn import kernel, ref
from repro_torch.kernels.flash_attn.ops import FlashAttention, \
    flash_attention, kernel_layout

F32 = dict(rtol=1e-5, atol=1e-5)
JAX = dict(rtol=2e-4, atol=2e-5)

# label, B, Sq, Sk, Hq, Hkv, dh, causal, window
CASES = [
    ("causal group 1", 1, 40, 40, 2, 2, 16, True, 0),
    ("causal group 2", 2, 24, 24, 4, 2, 16, True, 0),
    ("causal group 4, padded 100", 1, 100, 100, 8, 2, 32, True, 0),
    ("window 8", 1, 48, 48, 4, 2, 16, True, 8),
    ("window 24, group 4", 1, 70, 70, 4, 1, 16, True, 24),
    ("unmasked Sq > Sk", 1, 40, 12, 4, 2, 16, False, 0),
    ("unmasked Sq < Sk", 2, 24, 50, 2, 1, 16, False, 0),
]
IDS = [c[0] for c in CASES]


def _inputs(b, sq, sk, hq, hkv, dh, seed=0, dtype=torch.float32):
    """q, k, v (B, S, H, dh) and an upstream gradient, from numpy, rounded
    to ``dtype`` once."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, n, h, dh)).astype(np.float32)
            for n, h in ((sq, hq), (sk, hkv), (sk, hkv), (sq, hq))]
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _layout(q, k, v, do, causal, window):
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window)
    dof = kernel_layout(do, k, v, causal=causal, window=window)[0]
    # autograd hands the backward zeros on the padded rows
    dof[:, q.shape[1]:] = 0
    return qf, kf, vf, dof, kw


def _bwd_kw(kw):
    return {x: kw[x] for x in ("causal", "window", "group", "kv_len")}


def _autograd(q, k, v, do, causal, window):
    """Gradients through B6's plain forward, (B, S, H, dh) layout."""
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window)
    out = kernel.flash_attention_call(qf, kf, vf, **kw)
    b, sq, hq, dh = q.shape
    out = out.reshape(b, hq, -1, dh).transpose(1, 2)[:, :sq]
    return torch.autograd.grad(out, (q, k, v), do)


def _function(q, k, v, do, causal, window):
    """Gradients through ``ops.flash_attention`` (the Function)."""
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, window=window)
    return out, torch.autograd.grad(out, (q, k, v), do)


def _graph_has(fn, name: str) -> bool:
    """Whether the autograd graph under ``fn`` holds a node ``name``."""
    todo = [fn]
    while todo:
        node = todo.pop()
        if node is None:
            continue
        if type(node).__name__ == name:
            return True
        todo.extend(n for n, _ in node.next_functions)
    return False


def _from_layout(dq, dk, dv, q, k):
    """Kernel-layout gradients back to (B, S, H, dh)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    return (dq.reshape(b, hq, -1, dh).transpose(1, 2)[:, :sq],
            dk.reshape(b, hkv, -1, dh).transpose(1, 2)[:, :sk],
            dv.reshape(b, hkv, -1, dh).transpose(1, 2)[:, :sk])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd_in_float32(case):
    _, b, sq, sk, hq, hkv, dh, causal, window = case
    q, k, v, do = _inputs(b, sq, sk, hq, hkv, dh)
    qf, kf, vf, dof, kw = _layout(q, k, v, do, causal, window)
    out, lse = kernel.flash_attention_call(qf, kf, vf, **kw, return_lse=True)
    got = _from_layout(*ref.flash_attention_bwd_plain(
        qf, kf, vf, out, dof, lse, **_bwd_kw(kw)), q, k)
    for g, w in zip(got, _autograd(q, k, v, do, causal, window)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    """Against ``jax.vjp`` of the reference's naive oracle and of its
    chunked ``attention`` (the function its training differentiates)."""
    _, b, sq, sk, hq, hkv, dh, causal, window = case
    q, k, v, do = _inputs(b, sq, sk, hq, hkv, dh, seed=1)
    qf, kf, vf, dof, kw = _layout(q, k, v, do, causal, window)
    out, lse = kernel.flash_attention_call(qf, kf, vf, **kw, return_lse=True)
    got = _from_layout(*ref.flash_attention_bwd_plain(
        qf, kf, vf, out, dof, lse, **_bwd_kw(kw)), q, k)
    jx = [jnp.asarray(x.numpy()) for x in (q, k, v)]
    jdo = jnp.asarray(do.numpy())
    oracles = [lambda a, b_, c: ref_attention(a, b_, c, causal=causal,
                                              window=window)]
    if causal or sq == sk:  # the model's attention keeps q and k aligned
        oracles.append(lambda a, b_, c: jattn.attention(
            a, b_, c, causal=causal, window=window or None))
    for fn in oracles:
        _, vjp = jax.vjp(fn, *jx)
        for g, w in zip(got, vjp(jdo)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_is_the_rows_logsumexp(case):
    """The plain forward's log-sum-exp is each row's over its kept scores
    (f32), and its output is the same with or without it."""
    _, b, sq, sk, hq, hkv, dh, causal, window = case
    q, k, v, _ = _inputs(b, sq, sk, hq, hkv, dh, seed=2)
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window)
    out, lse = kernel.flash_attention_call(qf, kf, vf, **kw, return_lse=True)
    assert torch.equal(out, kernel.flash_attention_call(qf, kf, vf, **kw))
    s = ref.plain_scores(qf, kf, group=kw["group"])
    kpos = torch.arange(s.shape[-1])
    qpos = torch.arange(s.shape[1])
    keep = (kpos[None] < kw["kv_len"]).expand(s.shape[1], -1)
    if causal:
        keep = keep & (kpos[None] <= qpos[:, None])
    if window:
        keep = keep & (kpos[None] > qpos[:, None] - window)
    want = torch.logsumexp(torch.where(keep, s, -torch.inf), dim=-1)
    rows = keep.any(-1)  # a padded row of no kept key holds -1e30
    np.testing.assert_allclose(lse[:, rows].numpy(), want[:, rows].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert (lse[:, ~rows] == ref.NEG_INF).all()


@pytest.mark.parametrize("case", CASES[1:4], ids=IDS[1:4])
def test_bf16_plain_backward_within_its_bounds(case):
    """In bf16 the plain backward is held as the kernel is on the card: its
    distance from an f64 run of the same formulas (no bf16 rounding of P
    and dS) within ``ref.bwd_bounds``; and near autograd through the plain
    forward.  The bounds reject a dropped causal mask and dK of one query
    head a group."""
    _, b, sq, sk, hq, hkv, dh, causal, window = case
    q, k, v, do = _inputs(b, sq, sk, hq, hkv, dh, seed=3,
                          dtype=torch.bfloat16)
    qf, kf, vf, dof, kw = _layout(q, k, v, do, causal, window)
    out, lse = kernel.flash_attention_call(qf, kf, vf, **kw, return_lse=True)
    a = _bwd_kw(kw)
    got = ref.flash_attention_bwd_plain(qf, kf, vf, out, dof, lse, **a)
    exact = ref.flash_attention_bwd_plain(
        *(x.double() for x in (qf, kf, vf, out, dof, lse)), **a)
    bounds = ref.bwd_bounds(qf, kf, vf, out, dof, lse, **a)
    for g, e, bb in zip(got, exact, bounds):
        assert g.dtype == torch.bfloat16
        assert float(ref.bwd_ratio(g, e, bb).max()) <= 1
    auto = _autograd(q, k, v, do, causal, window)
    for g, w in zip(_from_layout(*got, q, k), auto):
        ulp = 2.0 ** (np.floor(np.log2(float(w.float().abs().max()))) - 7)
        assert float((g.float() - w.float()).abs().max()) <= 2 * ulp
    dropped = ref.flash_attention_bwd_plain(qf, kf, vf, out, dof, lse,
                                            **{**a, "causal": False})
    assert max(float(ref.bwd_ratio(x, w, bb).max())
               for x, w, bb in zip(dropped, got, bounds)) > 1
    g_ = kw["group"]
    if g_ > 1:
        one = ref.flash_attention_bwd_plain(
            qf[::g_].contiguous(), kf, vf, out[::g_].contiguous(),
            dof[::g_].contiguous(), lse[::g_].contiguous(),
            **{**a, "group": 1})
        assert float(ref.bwd_ratio(one[1], got[1], bounds[1]).max()) > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES[1:3] + CASES[5:6],
                         ids=IDS[1:3] + IDS[5:6])
def test_function_runs_the_plain_backward_on_the_cpu(case, dtype):
    """``ops.flash_attention`` under grad: the Function, whose gradients on
    CPU tensors are the plain backward's bit for bit (the path the card
    runs, with the plain versions in the kernels' places); its output is
    serving's."""
    _, b, sq, sk, hq, hkv, dh, causal, window = case
    q, k, v, do = _inputs(b, sq, sk, hq, hkv, dh, seed=4, dtype=dtype)
    out, grads = _function(q, k, v, do, causal, window)
    assert _graph_has(out.grad_fn, "FlashAttentionBackward")
    qf, kf, vf, dof, kw = _layout(q, k, v, do, causal, window)
    o, lse = kernel.flash_attention_call(qf, kf, vf, **kw, return_lse=True)
    want = _from_layout(*ref.flash_attention_bwd_plain(
        qf, kf, vf, o, dof, lse, **_bwd_kw(kw)), q, k)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        served = flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(out.detach(), served)


def test_serving_is_unchanged_under_no_grad():
    """No gradient wanted: one call of the wrapper, no log-sum-exp, no
    Function in the graph; inputs that require grad under ``no_grad``
    give the same bits."""
    q, k, v, _ = _inputs(1, 30, 30, 4, 2, 16, seed=5, dtype=torch.bfloat16)
    qf, kf, vf, kw = kernel_layout(q, k, v)
    want = kernel.flash_attention_call(qf, kf, vf, **kw)
    want = want.reshape(1, 4, -1, 16).transpose(1, 2)[:, :30]
    got = flash_attention(q, k, v)
    assert got.grad_fn is None and torch.equal(got, want)
    with torch.no_grad():
        got = flash_attention(*(x.requires_grad_(True) for x in (q, k, v)))
    assert got.grad_fn is None and torch.equal(got, want)


def test_function_applies_in_the_kernel_layout():
    """The Function takes and gives the kernel layout; autograd undoes the
    padding and head layout of ``kernel_layout`` (the padded rows' grads
    never reach the inputs)."""
    q, k, v, do = _inputs(1, 20, 20, 4, 2, 16, seed=6)
    qf, kf, vf, kw = kernel_layout(q, k, v)
    qf, kf, vf = (x.requires_grad_(True) for x in (qf, kf, vf))
    out = FlashAttention.apply(qf, kf, vf, kw)
    assert out.shape == qf.shape
    g = torch.autograd.grad(out, (qf, kf, vf), torch.ones_like(out))
    assert [x.shape for x in g] == [qf.shape, kf.shape, vf.shape]


def test_bwd_wrapper_refuses_what_the_kernel_cannot_take():
    """On the card B6-bwd takes bf16 kernel-layout tensors whose lengths
    are the forward's tiles' multiples (Sq of 128, Sk of 128 or of 64 at
    dh 128); the checks run before any launch (here on meta tensors, which
    reach them without a card)."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    q, k, out = t(8, 128, 64), t(4, 128, 64), t(8, 128, 64)
    lse = t(8, 128, dtype=torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.flash_attention_bwd_call(q, k, k, out, out, lse, group=2)
    with pytest.raises(ValueError, match="bf16 only"):
        kernel._check_bwd(*(x.float() for x in (q, k, k, out, out)), lse, 2,
                          128)
    with pytest.raises(ValueError, match="Sq a multiple of 128 and Sk of "
                                         "128"):
        kernel._check_bwd(t(8, 96, 64), t(4, 96, 64), t(4, 96, 64),
                          t(8, 96, 64), t(8, 96, 64),
                          t(8, 96, dtype=torch.float32), 2, 96)
    # Sk 64 is a whole kv tile at dh 128 only
    with pytest.raises(ValueError, match="Sk of 128"):
        kernel._check_bwd(t(8, 128, 64), t(4, 64, 64), t(4, 64, 64),
                          t(8, 128, 64), t(8, 128, 64), lse, 2, 64)
    kernel._check_bwd(t(8, 128, 128), t(4, 64, 128), t(4, 64, 128),
                      t(8, 128, 128), t(8, 128, 128), lse, 2, 64)
    with pytest.raises(ValueError, match="head dim"):
        kernel._check_bwd(t(8, 128, 48), t(4, 128, 48), t(4, 128, 48),
                          t(8, 128, 48), t(8, 128, 48), lse, 2, 128)
    with pytest.raises(ValueError, match="lse"):
        kernel._check_bwd(q, k, k, out, out, t(8, 64, dtype=torch.float32),
                          2, 128)


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True), (200, 50, False),
                                          (300, 300, True)],
                         ids=["100", "200 over 50", "300"])
def test_bwd_wrapper_takes_every_bf16_kernel_layout(dh, sq, sk, causal):
    """Every bf16 shape ``ops.kernel_layout`` gives the forward passes
    B6-bwd's checks (here on meta tensors): no training path is refused
    for its lengths."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    q, k = t(2, sq, 4, dh), t(2, sk, 2, dh)
    qf, kf, vf, kw = kernel_layout(q, k, k, causal=causal)
    assert (kw["block_q"], kw["block_k"]) == kernel.bf16_tiles(dh)
    lse = t(qf.shape[0], qf.shape[1], dtype=torch.float32)
    kernel._check_bwd(qf, kf, vf, qf, qf, lse, kw["group"], kw["kv_len"])

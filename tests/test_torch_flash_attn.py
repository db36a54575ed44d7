"""Port parity: the flash-attention kernel B6 (``kernels/flash_attn``) on the
CPU — its plain version, through ``ops.flash_attention`` — against the JAX
package's Pallas kernel in interpret mode and its naive oracle, on
identical numpy inputs, over the cases of ``tests/test_kernel_flash_attn.py``.

Tolerances: f32 rtol 2e-4, atol 2e-5 against both (the reference's own
kernel-vs-oracle tolerance; 5e-4 / 5e-5 for the hypothesis sweep, as
there).  bf16: element by element within one bf16 ulp of each element's
own magnitude (``ref.bf16_ulps``) of the JAX kernel, whose order of
operations the plain version repeats, and at most ``DIFFER_SHARE`` of the
elements not bit-equal; 2e-2 of the oracle, as the reference's own bf16
test.  The same element-wise check holds the CUDA kernel against the plain
version on the card; ``test_elementwise_check_catches_planted_faults``
shows what it reads on an emulation of the kernel's order and on planted
faults.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_fallback import given, settings, strategies as st

from repro.kernels.flash_attn.ops import flash_attention as jflash
from repro.kernels.flash_attn.ref import ref_attention
from repro_torch.kernels.flash_attn import kernel, ref
from repro_torch.kernels.flash_attn.ops import flash_attention, kernel_layout

# the reference's oracle, compiled once per shape (eagerly, op by op, it
# takes ~1 s a shape)
jref = jax.jit(ref_attention, static_argnames=("causal", "window"))

F32 = dict(rtol=2e-4, atol=2e-5)
DIFFER_SHARE = 1e-3


def _case(b, s, hq, hkv, dh, seed=0, dtype="float32", grid_qk=False,
          sk=None):
    """The same (B, S, H, dh) q, k, v for both packages (rounded to bf16
    once, for both, when ``dtype`` is bf16); k and v of ``sk`` rows when
    given (cross-attention).  ``grid_qk`` puts q and k on multiples of 1/8:
    then q k^T is exact in f32 in any order of summation."""
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    arrs = [rng.normal(size=(b, n, h, dh)).astype(np.float32)
            for n, h in ((s, hq), (sk, hkv), (sk, hkv))]
    if grid_qk:
        arrs[:2] = [np.round(a * 8) / 8 for a in arrs[:2]]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    px = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, px


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _check(jx, px, tol=F32, **kw):
    got = flash_attention(*px, **kw)
    assert got.dtype == px[0].dtype and got.shape == px[0].shape
    want_kernel = jflash(*jx, **kw)
    masks = {k: kw[k] for k in ("causal", "window") if k in kw}
    want = jref(*jx, **masks)
    if got.dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want_kernel), **tol)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        # the port's oracle is the reference's
        np.testing.assert_allclose(_np(ref.ref_attention(*px, **masks)),
                                   _np(want), rtol=1e-6, atol=1e-6)
    else:
        want_kernel = torch.from_numpy(_np(want_kernel)).to(torch.bfloat16)
        assert ref.bf16_ulps(got, want_kernel).max() <= 1
        assert (got != want_kernel).float().mean() <= DIFFER_SHARE
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    return got


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (6, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_kernel_and_oracle(hq, hkv, causal):
    jx, px = _case(2, 64, hq, hkv, 16)
    _check(jx, px, causal=causal, block_q=16, block_k=16)


@pytest.mark.parametrize("window", [8, 24])
def test_sliding_window(window):
    # window 8 < block 16: a row's first visited kv block can be fully
    # masked for it (exp(0) terms, wiped by the next real key)
    jx, px = _case(1, 96, 4, 2, 8, seed=1)
    got = _check(jx, px, causal=True, window=window, block_q=16, block_k=16)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("sq,sk", [(40, 12), (24, 50)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_has_its_own_kv_length(sq, sk, dtype):
    """Cross-attention (the encoder-decoder family): queries unmasked over
    fewer or more keys than themselves, both padded to blocks, the padded
    keys masked by ``kv_len``."""
    jx, px = _case(2, sq, 4, 2, 16, seed=4, dtype=dtype, sk=sk)
    got = _check(jx, px, causal=False, block_q=16, block_k=16)
    assert got.shape == (2, sq, 4, 16)


def test_ragged_seq_padding():
    jx, px = _case(1, 50, 2, 2, 8, seed=2)  # not a block multiple
    _check(jx, px, causal=True, block_q=16, block_k=16)


@settings(max_examples=8, deadline=None)
@given(s=st.integers(8, 96), hkv=st.sampled_from([1, 2]),
       g=st.sampled_from([1, 2, 3]), dh=st.sampled_from([8, 16]),
       bq=st.sampled_from([8, 16, 32]), seed=st.integers(0, 2**16))
def test_property_shapes(s, hkv, g, dh, bq, seed):
    jx, px = _case(1, s, hkv * g, hkv, dh, seed=seed)
    _check(jx, px, tol=dict(rtol=5e-4, atol=5e-5), causal=True, block_q=bq,
           block_k=bq)


def test_bf16_io():
    jx, px = _case(1, 64, 4, 2, 16, seed=3, dtype="bfloat16")
    _check(jx, px, causal=True, block_q=16, block_k=16)


@pytest.mark.parametrize("s,dh,window", [
    (256, 64, 0), (320, 64, 24), (256, 128, 0), (320, 128, 24),
    (50, 64, 0),  # a prompt shorter than one tile: padded, masked by kv_len
])
def test_bf16_at_the_hopper_kernels_tiles(s, dh, window):
    """The plain version at the bf16 kernel's tiles (q 128, kv 128 or 64 at
    dh 128), which ``ops.flash_attention`` takes by default for bf16,
    against the JAX kernel at the same blocks.  XLA and PyTorch sum q k^T
    in different orders, and at dh 64 a score one f32 ulp apart rounds its
    p to the neighbouring bf16 value often enough to move small outputs by
    several of their ulps (``ref.py``); on q and k of a coarse grid the
    scores are exact, and the check holds every operation after them."""
    block_q, block_k = kernel.bf16_tiles(dh)
    jx, px = _case(1, s, 4, 2, dh, seed=5, dtype="bfloat16", grid_qk=True)
    got = _check(jx, px, causal=True, window=window, block_q=block_q,
                 block_k=block_k)
    assert torch.equal(got, flash_attention(*px, causal=True, window=window))


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    """In the kernel's layout, a CPU tensor runs the plain version and no
    launch is counted; the plain version is deterministic."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((6, 32, 8), (2, 32, 8), (2, 32, 8)))
    kw = dict(causal=True, window=12, block_q=8, block_k=16, group=3,
              kv_len=27)
    before = kernel.flash_attention_call.launches
    got = kernel.flash_attention_call(q, k, v, **kw)
    assert kernel.flash_attention_call.launches == before
    assert torch.equal(got, ref.flash_attention_plain(q, k, v, **kw))
    assert torch.equal(got, ref.flash_attention_plain(q, k, v, **kw))
    want = jflash(*(jnp.asarray(t.numpy().reshape(
        -1, 1, 32, 8).transpose(1, 2, 0, 3)) for t in (q, k, v)),
        causal=True, window=12, block_q=8, block_k=16)
    # jflash over the whole 32 as kv_len; compare the rows kv_len does not
    # touch (causal rows < 27 never see keys >= 27)
    np.testing.assert_allclose(
        got.numpy()[:, :27], _np(want)[0].transpose(1, 0, 2)[:, :27], **F32)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.flash_attention_call(torch.empty((2, 8, 4), **meta),
                                    torch.empty((2, 8, 4), **meta),
                                    torch.empty((2, 8, 4), **meta))
    with pytest.raises(ValueError):
        ref.flash_attention_plain(torch.zeros(4, 10, 8), torch.zeros(2, 16, 8),
                                  torch.zeros(2, 16, 8), group=2,
                                  block_q=8, block_k=8)
    with pytest.raises(ValueError, match="scores"):  # the card's output only
        x = torch.zeros((2, 128, 64), dtype=torch.bfloat16)
        kernel.flash_attention_call(x, x, x, scores=torch.zeros(2, 128, 128))


def _kernel_order(q, k, v, *, causal, window, block_q, block_k, group, kv_len,
                  fault=None):
    """An emulation, on the CPU, of the bf16 CUDA kernel's order of
    operations (``csrc/flash_attn_sm90.cu``) in kernel layout, at its
    tiles: scores summed over dh in order (the tensor core's own order is
    not emulated), a thread's row sum over its columns 8 j + 2 t + e in 4
    partial sums (j mod 4) added as a tree, then an xor butterfly over the
    4 threads of a row, P V summed over the tile's keys in order, then
    ``acc * corr + o``.  ``fault`` plants one error of the order of
    operations."""
    bh, sq, dh = q.shape
    bkv, sk = k.shape[:2]
    scale = torch.tensor(1.0 / math.sqrt(dh))
    qf = q.reshape(bkv, group * sq, dh).float()
    q_pos = torch.arange(sq).repeat(group)
    q_blk = q_pos // block_q
    m = torch.full((bkv, group * sq, 1), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((bkv, group * sq, dh))
    for k_lo in range(0, sk, block_k):
        runs = torch.tensor([ref.block_runs(
            iq * block_q, block_q, k_lo, block_k, causal=causal,
            window=window) for iq in range(sq // block_q)])
        run = runs[q_blk][None, :, None]
        kb = k[:, k_lo:k_lo + block_k].float()
        vb = v[:, k_lo:k_lo + block_k].float()
        s = torch.zeros((bkv, group * sq, block_k))
        for d in range(dh):
            s = s + qf[:, :, d:d + 1] * kb[:, None, :, d]
        k_pos = k_lo + torch.arange(block_k)
        keep = k_pos[None] < kv_len
        if causal:
            keep = keep & (k_pos[None] <= q_pos[:, None])
        if window:
            keep = keep & (k_pos[None] > q_pos[:, None] - window)
        s = torch.where(keep[None], s * scale, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        pr = p if fault == "p not rounded" else p.to(v.dtype).float()
        if fault == "l sums the rounded p":
            p = pr
        part = p.reshape(bkv, -1, block_k // 8, 4, 2)      # [j, t, e]
        sums = [torch.zeros(part.shape[:2] + (4,)) for _ in range(4)]
        for j in range(block_k // 8):
            sums[j % 4] = sums[j % 4] + (part[:, :, j, :, 0]
                                         + part[:, :, j, :, 1])
        t = (sums[0] + sums[1]) + (sums[2] + sums[3])
        for off in (1, 2):
            t = t + t[..., torch.arange(4) ^ off]
        o = torch.zeros_like(acc)
        for kk in range(block_k):
            o = o + pr[:, :, kk:kk + 1] * vb[:, None, kk]
        acc_new = acc * corr + o
        if fault == "bf16 accumulator":
            acc_new = acc_new.bfloat16().float()
        m = torch.where(run, m_new, m)
        l = torch.where(run, l * corr + t[..., :1], l)
        acc = torch.where(run, acc_new, acc)
    return (acc / torch.clamp(l, min=1e-30)).reshape(bh, sq, dh).to(q.dtype)


@pytest.mark.parametrize("fault", [None, "p not rounded", "bf16 accumulator",
                                   "l sums the rounded p"])
def test_elementwise_check_catches_planted_faults(fault):
    """The check that holds B6's bf16 output against its plain version on
    the card (every element within 1 ulp of its own magnitude, at most
    ``DIFFER_SHARE`` of them not bit-equal) passes an emulation of the
    kernel's order, and fails each planted fault; a whole-tensor limit of
    one ulp of the largest magnitude passes the first two faults."""
    gen = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn((1, 512, h, 64), generator=gen).to(torch.bfloat16)
               for h in (8, 1, 1))
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=True)
    want = ref.flash_attention_plain(qf, kf, vf, **kw)
    got = _kernel_order(qf, kf, vf, **kw, fault=fault)
    ulps = float(ref.bf16_ulps(got, want).max())
    share = float((got != want).float().mean())
    err = float((got.double() - want.double()).abs().max())
    whole = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    print(f"{fault or 'kernel order'}: {ulps:g} ulps at worst, {share:.3g} "
          f"of the elements differ; max abs err {err:.3g} (one ulp of the "
          f"largest magnitude: {whole:.3g})")
    held = ulps <= 1 and share <= DIFFER_SHARE
    assert held == (fault is None)


def test_plain_version_takes_scores():
    """``scores=`` replaces only the plain version's product: given its own
    scores (``ref.plain_scores``) it returns the same bits, and the masks
    still apply to what it is given."""
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((1, 200, h, 64), generator=gen).to(torch.bfloat16)
               for h in (8, 2, 2))
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=True, window=24)
    scores = ref.plain_scores(qf, kf, group=kw["group"])
    want = ref.flash_attention_plain(qf, kf, vf, **kw)
    assert torch.equal(ref.flash_attention_plain(qf, kf, vf, **kw,
                                                 scores=scores), want)
    junk = scores.clone()
    masked = torch.arange(256)[None, :] > torch.arange(256)[:, None]
    junk[:, masked] = 1e4  # masked pairs: whatever they hold is masked
    assert torch.equal(ref.flash_attention_plain(qf, kf, vf, **kw,
                                                 scores=junk), want)


def test_scores_bound_holds_orders_and_catches_faults():
    """``ref.scores_bound`` holds the scores of another summation order
    (dh in reverse, in f32) with a wide margin, and not a dropped product
    or a bf16-rounded score."""
    gen = torch.Generator().manual_seed(8)
    q, k = (torch.randn((1, 256, h, 64), generator=gen).to(torch.bfloat16)
            for h in (4, 2))
    qf, kf, _, kw = kernel_layout(q, k, k, causal=True)
    g = kw["group"]
    want = ref.plain_scores(qf, kf, group=g)
    bound = ref.scores_bound(qf, kf, group=g)
    rev = ref.plain_scores(qf.flip(-1), kf.flip(-1), group=g)
    assert float(((rev - want).abs() / bound).max()) < 0.1
    drop = ref.plain_scores(qf[..., 1:], kf[..., 1:], group=g) * math.sqrt(
        63 / 64)
    assert float(((drop - want).abs() / bound).max()) > 1
    rounded = want.to(torch.bfloat16).float()
    assert float(((rounded - want).abs() / bound).max()) > 1

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA Hopper card and ``nvcc``; skips elsewhere (the decision is
made inside the fixture, not at import).  Imports nothing of JAX, so it
runs on a machine with PyTorch only:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from repro_torch.core import mrf_net, qat
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.flash_attn import ref as flash_ref
from repro_torch.kernels.flash_attn.ops import flash_attention, kernel_layout
from repro_torch.kernels.fused_train import kernel as train_kernel
from repro_torch.kernels.fused_train import multistep
from repro_torch.kernels.fused_train import ops as train_ops
from repro_torch.kernels.fused_train import ref as train_ref
from repro_torch.kernels.qat_dense import fused, kernel, ops, ref
from repro_torch.optim.optimizers import adam
from repro_torch.tree import leaves


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _net(hidden, device):
    g = torch.Generator(device=device).manual_seed(0)
    params = mrf_net.init_params(g, mrf_net.layer_sizes(32, hidden))
    qs = qat.init_qat_state(len(params), device=device)
    x = torch.randn((256, 64), generator=g, device=device)
    for _ in range(3):
        _, qs = qat.forward_qat(params, qs, x)
    return ops.prepad_int_layers(qat.export_int8(params, qs))


# every serving bucket, a whole wave of 8 slices (281,600 voxels), and
# ragged tiles; the wide net's image (~90 KB) needs the dynamic
# shared-memory limit raised
@pytest.mark.parametrize("hidden", [mrf_net.ADAPTED_HIDDEN,
                                    mrf_net.ORIGINAL_HIDDEN, (256, 256, 32)])
@pytest.mark.parametrize("m", [1, 129, 128, 256, 512, 1024, 281_600])
def test_fused_forward_matches_plain(cuda, hidden, m):
    net = _net(hidden, cuda)
    x = torch.randn((m, 64), device=cuda)
    drow = torch.tensor([4000.0, 600.0], device=cuda)
    before = fused.fused_forward_call.launches
    got = fused.fused_forward_call(x, net, drow=drow)
    want = ref.ref_fused_forward(x, net.s_in, net.packed, net.out_dim,
                                 drow=drow)
    torch.cuda.synchronize()
    assert fused.fused_forward_call.launches == before + 1
    assert torch.equal(got, want)


def _dense_case(mkn, device):
    m, k, n = mkn
    g = torch.Generator(device=device).manual_seed(sum(mkn))
    x = torch.randint(-128, 128, (m, k), generator=g, device=device,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=device,
                      dtype=torch.int8)
    b = torch.randint(-2048, 2048, (n,), generator=g, device=device,
                      dtype=torch.int32)
    s = torch.rand((n,), generator=g, device=device) * 1e-2 + 1e-4
    return x, w, b, s


# K and N that are not multiples of 32 and 8 (and of 4 and 2), a whole
# wave's M, and a K deeper than one 64-column slab's default
@pytest.mark.parametrize("mkn", [(1024, 64, 64), (130, 200, 300), (1, 4, 4),
                                 (33, 72, 20), (5, 37, 13), (77, 30, 6),
                                 (281_600, 64, 64), (300, 1000, 70)])
@pytest.mark.parametrize("relu,float_out",
                         [(True, False), (False, False), (False, True)])
def test_qat_dense_matches_plain(cuda, mkn, relu, float_out):
    x, w, b, s = _dense_case(mkn, cuda)
    before = kernel.qat_dense_call.launches
    got = kernel.qat_dense_call(x, w, b, s, relu=relu, float_out=float_out)
    want = ref.ref_qat_dense(x, w, b, s, relu=relu, float_out=float_out)
    torch.cuda.synchronize()
    assert kernel.qat_dense_call.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1024, 281_600])
def test_int8_kernels_repeat_bit_for_bit(cuda, m):
    """A second launch on the same inputs equals the first, bit for bit."""
    net = _net(mrf_net.ADAPTED_HIDDEN, cuda)
    x = torch.randn((m, 64), device=cuda)
    drow = torch.tensor([4000.0, 600.0], device=cuda)
    first = fused.fused_forward_call(x, net, drow=drow)
    assert torch.equal(fused.fused_forward_call(x, net, drow=drow), first)
    xq, w, b, s = _dense_case((m, 64, 64), cuda)
    first = kernel.qat_dense_call(xq, w, b, s)
    assert torch.equal(kernel.qat_dense_call(xq, w, b, s), first)


def test_empty_outputs_launch_and_count_nothing(cuda):
    net = _net(mrf_net.ADAPTED_HIDDEN, cuda)
    before = (fused.fused_forward_call.launches,
              kernel.qat_dense_call.launches)
    out = fused.fused_forward_call(torch.zeros((0, 64), device=cuda), net)
    assert out.shape == (0, net.out_dim)
    x = torch.zeros((0, 8), dtype=torch.int8, device=cuda)
    w = torch.zeros((8, 4), dtype=torch.int8, device=cuda)
    b = torch.zeros((4,), dtype=torch.int32, device=cuda)
    s = torch.ones((4,), device=cuda)
    assert kernel.qat_dense_call(x, w, b, s).shape == (0, 4)
    assert kernel.qat_dense_call(torch.zeros((4, 8), dtype=torch.int8,
                                             device=cuda), w[:, :0], b[:0],
                                 s[:0]).shape == (4, 0)
    assert (fused.fused_forward_call.launches,
            kernel.qat_dense_call.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.int8, device=cuda)
    w = torch.zeros((8, 4), dtype=torch.int8, device=cuda)
    b = torch.zeros((4,), dtype=torch.int32, device=cuda)
    s = torch.ones((4,), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.qat_dense_call(x.t().contiguous().t(), w.t().contiguous().t()
                              [:, :4], b, s)
    with pytest.raises(ValueError):
        kernel.qat_dense_call(x.float(), w, b, s)
    with pytest.raises(ValueError):
        kernel.qat_dense_call(x, w, b.cpu(), s)
    deep = torch.zeros((4, 8192), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="too deep"):
        kernel.qat_dense_call(deep, torch.zeros((8192, 64), dtype=torch.int8,
                                                device=cuda),
                              torch.zeros((64,), dtype=torch.int32,
                                          device=cuda),
                              torch.ones((64,), device=cuda))


# --------------------------------------------------------------------------
# fused training (csrc/fused_train.cu): B1, B2, B3 against the plain version
# --------------------------------------------------------------------------

def _train_case(hidden, rows, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    params = mrf_net.init_params(g, mrf_net.layer_sizes(32, hidden))
    x = 0.2 * torch.randn((rows, 64), generator=g, device=device)
    y = torch.rand((rows, 2), generator=g, device=device)
    return params, x, y


def _max_err(a, b) -> float:
    """Largest difference of two trees (0 for two empty ones, e.g. SGD's
    ``None`` state); fails on trees of other structure."""
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    return max((float((u - v).abs().max()) for u, v in zip(la, lb)),
               default=0.0)


# every cluster the wrapper takes: its default (None), and each size; a
# size whose plan does not fit a block is refused with ValueError
CLUSTERS = [None, 1, 2, 4, 8, 16]


def _refused(tile, widths, cluster) -> bool:
    return (cluster is not None
            and cluster not in train_kernel.cluster_sizes(tile, widths))


@pytest.mark.parametrize("hidden", [mrf_net.ADAPTED_HIDDEN,
                                    mrf_net.ORIGINAL_HIDDEN])
@pytest.mark.parametrize("tile,rows", [(1, 1024), (128, 256)])
@pytest.mark.parametrize("qat_on", [False, True])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_fused_train_step_matches_plain(cuda, hidden, tile, rows, qat_on,
                                        cluster):
    """B1 against the plain version (atol 1e-5) at each cluster size, and
    bit-equal to its repeat.  At tile 1 over 1,024 rows (the per-sample
    stream) the comparison is ``ref.stream_divergence``: with QAT the
    fake-quant is discontinuous, and once the two versions' sums (taken in
    other orders) leave a weight an ulp to either side of a rounding tie the
    two runs train different nets.  So every update is held from the
    kernel's own net, and the two runs side by side up to the first int8
    level flip (without QAT, over the whole stream)."""
    params, x, y = _train_case(hidden, rows, cuda)
    flat, widths = train_ops.pack_params(params)

    def b1(xr, yr, p):
        return train_kernel.fused_train_call(xr, yr, p, widths=widths,
                                             lr=1e-2, tile_batch=tile,
                                             qat=qat_on, cluster=cluster)

    if _refused(tile, widths, cluster):
        with pytest.raises(ValueError, match="shared memory"):
            b1(x, y, flat)
        return
    before = train_kernel.fused_train_call.launches
    got_p, got_l = b1(x, y, flat)
    again_p, again_l = b1(x, y, flat)
    torch.cuda.synchronize()
    assert train_kernel.fused_train_call.launches == before + 2
    assert train_kernel.run_fused_train.last_cluster == (
        train_kernel.cluster_size(tile, widths) if cluster is None
        else cluster)
    assert torch.equal(got_p, again_p) and torch.equal(got_l, again_l)
    if tile == 1:
        div = train_ref.stream_divergence(b1, x, y, flat, widths, lr=1e-2,
                                          qat=qat_on)
        assert torch.equal(div["params"], got_p)
        assert torch.equal(div["losses"], got_l)
        assert div["local_err"] <= 1e-5 and div["free_err"] <= 1e-5
        if not qat_on:
            assert div["first_flip"] is None and div["end_err"] <= 1e-5
        return
    want_p, _, _, want_l = train_ref.fused_train_plain(
        x, y, flat, widths, lr=1e-2, tile_batch=tile, qat=qat_on)
    assert float((got_l - want_l).abs().max()) <= 1e-5
    assert float((got_p - want_p).abs().max()) <= 1e-5


def _hold_multistep(cuda, hidden, optimizer, qat_on, cluster, k_steps,
                    per_step, tile_batch=128, seed=1):
    """B2 / B3 at K steps of ``per_step`` rows against the plain version
    (params and losses atol 1e-5, Adam's moments atol 1e-6 / rtol 1e-5),
    then bit for bit against K single-step launches and against itself.
    Returns the tile the launch took."""
    lr = 1e-3
    params, x, y = _train_case(hidden, k_steps * per_step, cuda, seed=seed)

    def fresh():
        return adam(lr).init(params) if optimizer == "adam" else None

    def run(p, s, xs, ys, n):
        return train_ops.fused_train_multistep(
            p, s, xs, ys, n_steps=n, lr=lr, optimizer=optimizer,
            tile_batch=tile_batch, qat=qat_on, cluster=cluster)

    counter = (multistep.fused_train_adam_call if optimizer == "adam"
               else multistep.fused_train_multistep_call)
    tile = train_ops.effective_tile(per_step, tile_batch)
    before = counter.launches
    got = run(params, fresh(), x, y, k_steps)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    flat, widths = train_ops.pack_params(params)
    moments = step0 = None
    if optimizer == "adam":
        moments = (torch.zeros_like(flat), torch.zeros_like(flat))
        step0 = torch.zeros((1,), dtype=torch.int32, device=cuda)
    want_p, want_mu, want_nu, want_l = train_ref.fused_train_plain(
        x, y, flat, widths, lr=lr, tile_batch=tile, qat=qat_on,
        moments=moments, step0=step0)
    got_flat, _ = train_ops.pack_params(got[0])
    assert float((got_flat - want_p).abs().max()) <= 1e-5
    assert float((got[2].reshape(-1) - want_l).abs().max()) <= 1e-5
    if optimizer == "adam":
        for mom, want in ((got[1].mu, want_mu), (got[1].nu, want_nu)):
            packed, _ = train_ops.pack_params(mom)
            assert torch.allclose(packed, want, atol=1e-6, rtol=1e-5)
        assert int(got[1].step) == k_steps * (per_step // tile)
    seq_p, seq_s, rows = params, fresh(), []
    for k in range(k_steps):
        sl = slice(k * per_step, (k + 1) * per_step)
        seq_p, seq_s, tl = run(seq_p, seq_s, x[sl], y[sl], 1)
        rows.append(tl[0])
    again = run(params, fresh(), x, y, k_steps)
    torch.cuda.synchronize()
    assert torch.equal(got[2], torch.stack(rows))
    assert _max_err(got[0], seq_p) == 0.0 and _max_err(got[0], again[0]) == 0.0
    assert _max_err(got[1], seq_s) == 0.0 and _max_err(got[1], again[1]) == 0.0
    assert torch.equal(got[2], again[2])
    return tile


@pytest.mark.parametrize("hidden", [mrf_net.ADAPTED_HIDDEN,
                                    mrf_net.ORIGINAL_HIDDEN])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("qat_on", [False, True])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_multistep_matches_plain_and_k_single_steps(cuda, hidden, optimizer,
                                                    qat_on, cluster):
    """B2 / B3 at K=4, batch 256, tile 128 at each cluster size (mrf-original
    with QAT and Adam among them)."""
    widths = mrf_net.layer_sizes(32, hidden)
    if _refused(128, widths, cluster):
        with pytest.raises(ValueError, match="shared memory"):
            _hold_multistep(cuda, hidden, optimizer, qat_on, cluster, 4, 256)
        return
    _hold_multistep(cuda, hidden, optimizer, qat_on, cluster, 4, 256)
    assert train_kernel.run_fused_train.last_cluster == (
        train_kernel.cluster_size(128, widths) if cluster is None
        else cluster)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("case", ["ragged", "tile_below_cluster"])
def test_multistep_ragged_and_tiny_tiles(cuda, optimizer, case):
    """A ragged tile of 127 rows (batch 254: the 8 blocks take 16 rows, the
    last 15) at the default cluster, and tiles of 4 rows on 8 blocks (4 of
    them take no row), each held like the main case."""
    per_step, tile_batch, cluster = ((254, 128, None) if case == "ragged"
                                     else (8, 4, 8))
    tile = _hold_multistep(cuda, mrf_net.ADAPTED_HIDDEN, optimizer, False,
                           cluster, 3, per_step, tile_batch=tile_batch)
    assert tile == (127 if case == "ragged" else 4)
    assert train_kernel.run_fused_train.last_cluster == 8


def test_fused_train_empty_batch_launches_and_counts_nothing(cuda):
    params, _, _ = _train_case(mrf_net.ADAPTED_HIDDEN, 1, cuda)
    flat, widths = train_ops.pack_params(params)
    counters = (train_kernel.fused_train_call, multistep.fused_train_multistep_call,
                multistep.fused_train_adam_call)
    before = [c.launches for c in counters]
    x = torch.zeros((0, 64), device=cuda)
    y = torch.zeros((0, 2), device=cuda)
    p, losses = train_kernel.fused_train_call(x, y, flat, widths=widths,
                                              lr=1e-2, tile_batch=4)
    assert torch.equal(p, flat) and losses.shape == (0,)
    step0 = torch.zeros((1,), dtype=torch.int32, device=cuda)
    out = multistep.fused_train_adam_call(step0, x, y, flat, flat, flat,
                                          widths=widths, lr=1e-3,
                                          tile_batch=4)
    assert torch.equal(out[1], flat) and out[3].shape == (0,)
    assert [c.launches for c in counters] == before


def test_fused_train_refuses_a_net_beyond_shared_memory(cuda):
    widths = (64, 256, 256, 2)  # 267 KB of weights: over the 227 KB a block has
    flat = torch.zeros((train_ref.packed_size(widths),), device=cuda)
    x, y = torch.zeros((4, 64), device=cuda), torch.zeros((4, 2), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        train_kernel.fused_train_call(x, y, flat, widths=widths, lr=1e-2,
                                      tile_batch=4)
    with pytest.raises(ValueError, match="contiguous"):
        train_kernel.fused_train_call(
            x, torch.zeros((2, 4), device=cuda).t(), flat[:130],
            widths=(64, 2), lr=1e-2, tile_batch=4)


# f32 within atol 2e-5 at the block named; bf16 at the Hopper kernel's own
# tiles: its scores within ``ref.scores_bound`` of the plain version's (the
# tensor cores sum q k^T in their own order), and its output element by
# element within one bf16 ulp of each element's own magnitude, and at most
# 1e-3 of the elements not bit-equal, against the plain version run on
# those scores (``chip_smoke.hold_b6_bf16`` says why)
@pytest.mark.parametrize("case", [
    # B, S or (Sq, Sk), Hq, Hkv, dh, causal, window, f32 block
    (2, 512, 32, 4, 64, True, 0, 64),
    (1, 320, 8, 2, 64, True, 24, 64),
    (1, 320, 8, 2, 64, True, 8, 64),
    (2, 256, 8, 2, 64, False, 0, 64),
    (1, 200, 8, 2, 64, True, 0, 64),
    (2, 256, 4, 4, 64, True, 0, 64),
    (1, 256, 8, 2, 128, True, 0, 64),
    (2, 2048, 32, 8, 128, True, 0, 64),
    (1, 50, 6, 2, 16, True, 8, 16),
    # hymba-1.5b's prefill: group 5, its window of 1,024 and a global layer
    (8, 2048, 25, 5, 64, True, 1024, 64),
    (8, 2048, 25, 5, 64, True, 0, 64),
    # seamless-m4t-large-v2: its encoder, its cross-attention (decoder
    # queries over encoder keys, unmasked), a ragged cross case (kv_len
    # masks the padded keys); llava-next-34b: group 7 at dh 128
    (8, 512, 16, 16, 64, False, 0, 64),
    (8, (2048, 512), 16, 16, 64, False, 0, 64),
    (2, (200, 50), 8, 2, 64, False, 0, 64),
    (4, 3072, 56, 8, 128, True, 0, 64),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_matches_plain(cuda, case, dtype):
    b, s, hq, hkv, dh, causal, window, blk = case
    s, sk = s if isinstance(s, tuple) else (s, s)
    blk = blk if dtype == torch.float32 else None
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, n, h, dh), generator=g, device=cuda).to(dtype)
               for n, h in ((s, hq), (sk, hkv), (sk, hkv)))
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window,
                                   block_q=blk, block_k=blk)
    if dtype == torch.bfloat16:
        assert (kw["block_q"], kw["block_k"]) == flash_kernel.bf16_tiles(dh)
    before = flash_kernel.flash_attention_call.launches
    got = flash_kernel.flash_attention_call(qf, kf, vf, **kw)
    again = flash_kernel.flash_attention_call(qf, kf, vf, **kw)
    out = flash_attention(q, k, v, causal=causal, window=window, block_q=blk,
                          block_k=blk)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention_call.launches == before + 3
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert torch.equal(out, got.reshape(b, hq, -1, dh).transpose(1, 2)[:, :s])
    if dtype == torch.float32:
        want = flash_ref.flash_attention_plain(qf, kf, vf, **kw)
        assert (got.double() - want.double()).abs().max().item() <= 2e-5
        return
    scores = torch.full((qf.shape[0], qf.shape[1], kf.shape[1]), float("nan"),
                        device=cuda)
    assert torch.equal(flash_kernel.flash_attention_call(
        qf, kf, vf, **kw, scores=scores), got)
    ran = ~torch.isnan(scores)
    gap = (scores - flash_ref.plain_scores(qf, kf, group=kw["group"])).abs()
    bound = flash_ref.scores_bound(qf, kf, group=kw["group"])
    assert (gap[ran] <= bound[ran]).all()
    want = flash_ref.flash_attention_plain(qf, kf, vf, **kw, scores=scores)
    assert flash_ref.bf16_ulps(got, want).max().item() <= 1
    assert (got != want).float().mean().item() <= 1e-3


@pytest.mark.parametrize("case", [
    # B, S or (Sq, Sk), Hq, Hkv, dh, causal, window
    (2, 256, 8, 2, 64, True, 0),
    (1, 300, 8, 2, 32, True, 0),
    (1, 320, 8, 2, 128, True, 24),
    (1, 200, 4, 2, 16, True, 24),
    (2, (200, 50), 8, 2, 64, False, 0),
    (1, 1024, 56, 8, 128, True, 0),
    # the Hopper kernels' tile edges: one q tile with kv_len inside a kv
    # tile, a window across kv tiles, kv lengths of 64-row tiles at dh 128
    # (the dK/dV item's second half past the keys), kv_len inside a tile
    (1, 100, 4, 1, 64, True, 0),
    (1, 512, 4, 2, 64, True, 200),
    (1, 192, 4, 2, 128, True, 0),
    (2, (256, 64), 4, 4, 128, False, 0),
    (1, (256, 90), 4, 2, 32, False, 0),
])
def test_flash_attention_bwd_matches_plain(cuda, case):
    """B6 with its log-sum-exp (the output unchanged) and B6-bwd against
    the plain backward within ``ref.bwd_bounds``, a launch bit for bit its
    repeat; ``ops.flash_attention`` under grad runs both kernels."""
    b, s, hq, hkv, dh, causal, window = case
    s, sk = s if isinstance(s, tuple) else (s, s)
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn((b, n, h, dh), generator=g,
                               device=cuda).to(torch.bfloat16)
                   for n, h in ((s, hq), (sk, hkv), (sk, hkv), (s, hq)))
    qf, kf, vf, kw = kernel_layout(q, k, v, causal=causal, window=window)
    dof = kernel_layout(do, k, v, causal=causal, window=window)[0]
    dof[:, s:] = 0
    fwd, bwd = flash_kernel.flash_attention_call, \
        flash_kernel.flash_attention_bwd_call
    out, lse = fwd(qf, kf, vf, **kw, return_lse=True)
    assert torch.equal(out, fwd(qf, kf, vf, **kw))
    want_lse = flash_ref.flash_attention_plain(qf, kf, vf, **kw,
                                               return_lse=True)[1]
    assert (lse - want_lse).abs().max().item() <= 1e-4
    a = {x: kw[x] for x in ("causal", "window", "group", "kv_len")}
    before = bwd.launches
    got = bwd(qf, kf, vf, out, dof, lse, **a)
    again = bwd(qf, kf, vf, out, dof, lse, **a)
    torch.cuda.synchronize()
    assert bwd.launches == before + 2
    want = flash_ref.flash_attention_bwd_plain(qf, kf, vf, out, dof, lse, **a)
    bounds = flash_ref.bwd_bounds(qf, kf, vf, out, dof, lse, **a)
    for x, y, w, bb in zip(got, again, want, bounds):
        assert torch.equal(x, y) and torch.isfinite(x).all()
        assert flash_ref.bwd_ratio(x, w, bb).max().item() <= 1
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    fb, bb_ = fwd.launches, bwd.launches
    o = flash_attention(qg, kg, vg, causal=causal, window=window)
    grads = torch.autograd.grad(o, (qg, kg, vg), do)
    assert (fwd.launches, bwd.launches) == (fb + 1, bb_ + 1)
    for x, w, n in zip(grads, got, (hq, hkv, hkv)):
        assert torch.equal(
            x, w.reshape(b, n, -1, dh).transpose(1, 2)[:, :x.shape[1]])
    with pytest.raises(RuntimeError, match="requires grad"):
        fwd(qg.detach().requires_grad_(True).reshape(-1, s, dh)
            .contiguous(), kf, vf, **kw)


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((4, 128, 64), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((2, 128, 64), device=cuda, dtype=torch.bfloat16)
    call = flash_kernel.flash_attention_call
    # bf16 runs the Hopper kernel at its own tiles only, never elsewhere
    for bq, bk in ((64, 64), (128, 64), (64, 128), (128, 32)):
        with pytest.raises(ValueError, match="block"):
            call(q, k, k, group=2, block_q=bq, block_k=bk)
    with pytest.raises(ValueError, match="head dim"):
        odd = torch.zeros((4, 128, 48), device=cuda, dtype=torch.bfloat16)
        call(odd, odd[:2], odd[:2], group=2)
    with pytest.raises(ValueError, match="scores"):
        call(q, k, k, group=2, scores=torch.zeros((4, 128, 128), device=cuda,
                                                  dtype=torch.bfloat16))
    # float32 runs the scalar kernel, tiles of at most 64 rows
    with pytest.raises(ValueError, match="block_q"):
        call(q.float(), k.float(), k.float(), group=2, block_q=128,
             block_k=64)
    with pytest.raises(ValueError, match="dtype"):
        call(q.half(), k.half(), k.half(), group=2)
    with pytest.raises(ValueError, match="contiguous"):
        call(q.transpose(0, 1), k, k, group=2)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros((4, 64, 256), device=cuda)
        call(wide, wide[:2], wide[:2], group=2)

"""Port parity: the int8 layer and the whole int8 net, bit-exact against the
JAX package (``repro.kernels.qat_dense`` run in interpret mode on the CPU,
and the eager ``qat.int_forward`` oracle).

Inputs are made with numpy from a seed and handed to both packages.  On
the CPU the port's kernel wrappers run their plain PyTorch versions; the
CUDA kernels themselves are held against those versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as jqat
from repro.data.pipeline import denormalize_targets as j_denorm
from repro.kernels.qat_dense import ops as jops
from repro.kernels.qat_dense import ref as jref
from repro_torch.convert import int_layers_from_numpy
from repro_torch.core import qat as pqat
from repro_torch.data.pipeline import denormalize_targets as p_denorm
from repro_torch.kernels.qat_dense import fused as pfused
from repro_torch.kernels.qat_dense import kernel as pkernel
from repro_torch.kernels.qat_dense import ops as pops
from repro_torch.kernels.qat_dense import ref as pref

jax.config.update("jax_platform_name", "cpu")

ARCH_HIDDEN = {"mrf-fpga": (64, 64, 32, 16, 16, 16),
               "mrf-original": (128, 128, 64, 64, 32, 16, 16, 16)}
N_FRAMES = 32
DSCALE = np.array([4000.0, 600.0], np.float32)


def _rand_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (m, k)).astype(np.int8),
            rng.integers(-128, 128, (k, n)).astype(np.int8),
            rng.integers(-2048, 2048, (n,)).astype(np.int32),
            rng.uniform(1e-4, 1e-2, (n,)).astype(np.float32))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("mkn", [(8, 64, 32), (130, 200, 300), (1, 64, 2),
                                 (256, 256, 128)])
@pytest.mark.parametrize("relu,float_out",
                         [(True, False), (False, False), (False, True)])
def test_qat_dense_bitexact_vs_jax(mkn, relu, float_out):
    case = _rand_case(*mkn, seed=sum(mkn))
    kw = dict(relu=relu, float_out=float_out)
    want_ops = np.asarray(jops.qat_dense(*map(jnp.asarray, case), **kw))
    want_ref = np.asarray(jref.ref_qat_dense(*map(jnp.asarray, case), **kw))
    np.testing.assert_array_equal(want_ops, want_ref)
    for got in (pops.qat_dense(*_t(*case), **kw),
                pops.qat_dense_lax(*_t(*case), **kw),
                pref.ref_qat_dense(*_t(*case), **kw)):
        assert got.dtype == (torch.float32 if float_out else torch.int8)
        np.testing.assert_array_equal(got.numpy(), want_ops)


def _jax_net(hidden, seed=1):
    """A calibrated, exported JAX int8 net from numpy-made params."""
    sizes = (2 * N_FRAMES, *hidden, 2)
    rng = np.random.default_rng(seed)
    params = [{"w": jnp.asarray(rng.uniform(-1, 1, (i, o)).astype(np.float32)
                                * np.float32(np.sqrt(6.0 / i))),
               "b": jnp.asarray(rng.normal(0, 0.05, (o,)).astype(np.float32))}
              for i, o in zip(sizes[:-1], sizes[1:])]
    qs = jqat.init_qat_state(len(params))
    x = jnp.asarray(rng.normal(size=(64, sizes[0])).astype(np.float32))
    for _ in range(5):
        _, qs = jqat.forward_qat(params, qs, x)
    return jqat.export_int8(params, qs)


def _to_port(ints):
    return int_layers_from_numpy(
        [{"w_q": np.asarray(layer.w_q), "b_q": np.asarray(layer.b_q),
          "s_in": np.asarray(layer.s_in), "s_w": np.asarray(layer.s_w),
          "s_out": None if layer.s_out is None else np.asarray(layer.s_out)}
         for layer in ints], device="cpu")


@pytest.fixture(scope="module", params=sorted(ARCH_HIDDEN))
def nets(request):
    ints = _jax_net(ARCH_HIDDEN[request.param])
    return ints, _to_port(ints)


@pytest.mark.parametrize("m", [1, 7, 300])
def test_int_net_bitexact_vs_jax(nets, m):
    ints, pints = nets
    x = np.random.default_rng(m).normal(size=(m, 2 * N_FRAMES)).astype(
        np.float32)
    want = np.asarray(jqat.int_forward(ints, jnp.asarray(x)))
    want_ms = np.asarray(j_denorm(want))
    want_fused = np.asarray(jops.int_forward_fused(
        jops.prepad_int_layers(ints), jnp.asarray(x), denorm_scale=DSCALE))
    np.testing.assert_array_equal(want_fused, want_ms)

    xt = torch.from_numpy(x)
    net = pops.prepad_int_layers(pints)
    np.testing.assert_array_equal(pqat.int_forward(pints, xt).numpy(), want)
    np.testing.assert_array_equal(pops.int_forward_fused(net, xt).numpy(),
                                  want)
    np.testing.assert_array_equal(pops.int_forward_layered(net, xt).numpy(),
                                  want)
    np.testing.assert_array_equal(pops.int_forward_lax(pints, xt).numpy(),
                                  want)
    # denormalization: fused into the kernel's epilogue, composed outside
    np.testing.assert_array_equal(
        pops.int_forward_fused(net, xt, denorm_scale=DSCALE).numpy(), want_ms)
    for fwd in (pops.int_forward_layered(net, xt),
                pops.int_forward_lax(pints, xt)):
        np.testing.assert_array_equal(p_denorm(fwd).numpy(), want_ms)


def test_half_to_even_tie_case(nets):
    """Features whose x / s_in lands exactly on k + 0.5 must round to the
    even neighbour in every path (roundf or a reciprocal multiply would
    not)."""
    ints, pints = nets
    s_in = np.float32(np.asarray(ints[0].s_in))
    halves = np.arange(-120, 120, dtype=np.float32) + np.float32(0.5)
    x = (halves * s_in).astype(np.float32)
    x = x[(x / s_in) == halves]  # keep exact ties only
    assert x.size >= 40
    x = np.resize(x, (2, 2 * N_FRAMES)).astype(np.float32)
    q = (x / s_in).astype(np.float32)
    q_even = np.round(q)  # numpy rounds half to even
    assert np.any(q_even != np.floor(q + 0.5))  # the tie case really differs
    np.testing.assert_array_equal(
        pqat.quantize_input(torch.from_numpy(x), pints[0].s_in).numpy(),
        np.clip(q_even, -128, 127).astype(np.int8))

    want = np.asarray(jqat.int_forward(ints, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    net = pops.prepad_int_layers(pints)
    for got in (pops.int_forward_fused(net, xt), pops.int_forward_layered(
            net, xt), pops.int_forward_lax(pints, xt),
            pqat.int_forward(pints, xt)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_prepad_scales_keep_oracle_grouping(nets):
    ints, pints = nets
    net = pops.prepad_int_layers(pints)
    jnet = jops.prepad_int_layers(ints)
    for i in range(net.n_layers):
        n = int(ints[i].w_q.shape[1])
        np.testing.assert_array_equal(
            net.packed[3 * i + 2].numpy()[:n],
            np.asarray(jnet.packed[3 * i + 2]).reshape(-1)[:n])
        assert net.packed[3 * i].shape[0] % pops.PAD == 0
        assert net.packed[3 * i].shape[1] % pops.PAD == 0
    assert net.padded_widths[-1] == 4 and net.out_dim == 2


def test_fused_image_layout(nets):
    """The packed image holds each layer's weights as mma.m16n8k32 B
    fragments in fragment order (K padded to 32, N to 8, the first layer on
    the kInput k map, the others on the kChain map), then its biases and
    scales padded with zeros, where its header says."""
    _, pints = nets
    net = pops.prepad_int_layers(pints)
    words = net.image.numpy().view(np.int32)
    assert net.image.numel() % 16 == 0
    widest = 0
    for i in range(net.n_layers):
        kch, nt, f_off, bs_off = (int(v) for v in words[4 * i:4 * i + 4])
        w, b, s = (t.numpy() for t in net.packed[3 * i:3 * i + 3])
        k, n = w.shape
        assert (kch, nt) == (-(-k // 32), -(-n // 8))
        assert f_off % 2 == 0 and bs_off == f_off + kch * nt * 64
        frag = words[f_off:bs_off].view(np.int8).reshape(kch, nt, 8, 4, 2, 4)
        wp = np.zeros((32 * kch, 8 * nt), np.int8)
        wp[:k, :n] = w
        for kc in range(kch):
            for j in range(nt):
                for g in range(8):
                    for t in range(4):
                        for h in range(2):
                            for q in range(4):
                                row = (8 * t + 4 * h + q if i == 0 else
                                       16 * h + 8 * (q // 2) + 2 * t + q % 2)
                                assert frag[kc, j, g, t, h, q] == \
                                    wp[32 * kc + row, 8 * j + g]
        bs = words[bs_off:bs_off + 16 * nt]
        np.testing.assert_array_equal(bs[:n], b)
        assert not bs[n:8 * nt].any() and not bs[8 * nt + n:].any()
        np.testing.assert_array_equal(bs[8 * nt:8 * nt + n].view(np.float32), s)
        widest = max(widest, kch, -(-nt // 4))
    assert net.act_chunks == widest
    assert pfused.smem_bytes(net.image.numel(), net.act_chunks) < 227 * 1024


# --- numpy emulation of the tensor-core kernels' fragment arithmetic -------
# One warp, lane = 4 g + t, carries 16 rows; registers as mma.m16n8k32 .s8
# lays them out (csrc/int8_mma.cuh).  A register set is (lanes, 4) uint32,
# a B fragment (lanes, 2) uint32.

def _bytes(regs):
    return regs.astype(np.uint32).view(np.int8).astype(np.int64)


def _a_matrix(regs):
    """(tiles, 32, 4) uint32 -> A (tiles, 16, 32)."""
    by = _bytes(regs).reshape(regs.shape[0], 8, 4, 4, 4)  # tile, g, t, reg, q
    a = np.zeros((regs.shape[0], 16, 32), np.int64)
    for t in range(4):
        a[:, :8, 4 * t:4 * t + 4] = by[:, :, t, 0]
        a[:, 8:, 4 * t:4 * t + 4] = by[:, :, t, 1]
        a[:, :8, 16 + 4 * t:20 + 4 * t] = by[:, :, t, 2]
        a[:, 8:, 16 + 4 * t:20 + 4 * t] = by[:, :, t, 3]
    return a


def _b_matrix(words):
    """(32, 2) uint32 -> B (32, 8)."""
    by = _bytes(words).reshape(8, 4, 2, 4)  # g, t, half, q
    b = np.zeros((32, 8), np.int64)
    for t in range(4):
        b[4 * t:4 * t + 4, :] = by[:, t, 0].T
        b[16 + 4 * t:20 + 4 * t, :] = by[:, t, 1].T
    return b


def _d_fragment(d):
    """D (tiles, 16, 8) -> (tiles, 32 lanes, 4): d0, d1 = D[g][2t], D[g][2t+1];
    d2, d3 = D[g+8][2t], D[g+8][2t+1]."""
    out = np.zeros((d.shape[0], 8, 4, 4), np.int64)
    for t in range(4):
        out[:, :, t, 0] = d[:, :8, 2 * t]
        out[:, :, t, 1] = d[:, :8, 2 * t + 1]
        out[:, :, t, 2] = d[:, 8:, 2 * t]
        out[:, :, t, 3] = d[:, 8:, 2 * t + 1]
    return out.reshape(d.shape[0], 32, 4)


def _pack4(b):
    """(..., 4) int bytes -> uint32, byte 0 lowest."""
    b = (np.asarray(b, np.int64) & 0xff).astype(np.uint32)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _input_registers(rows8, n_chunks):
    """A registers from (tiles, 16, 32 n_chunks) int8 values on the kInput
    map: lane t's a[0] = row g, k 8t..8t+3; a[2] = row g, 8t+4..8t+7; a[1]
    and a[3] the same of row g + 8."""
    tiles = rows8.shape[0]
    regs = np.zeros((n_chunks, tiles, 32, 4), np.uint32)
    for kc in range(n_chunks):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            c = 32 * kc + 8 * t
            regs[kc, :, lane, 0] = _pack4(rows8[:, g, c:c + 4])
            regs[kc, :, lane, 1] = _pack4(rows8[:, g + 8, c:c + 4])
            regs[kc, :, lane, 2] = _pack4(rows8[:, g, c + 4:c + 8])
            regs[kc, :, lane, 3] = _pack4(rows8[:, g + 8, c + 4:c + 8])
    return regs


def _rescale(acc, bias, scale):
    return (acc + bias).astype(np.int32).astype(np.float32) * scale


def _emulate_fused(image, x, s_in, out_dim, drow=None):
    """fused_forward.cu on numpy: reads the image through its header and
    fragment order, quantizes x on the kInput map, chains layers through
    the kChain map.  Returns (out (M, out_dim) fp32, per layer the int32
    accumulators plus bias (M, N padded to 8))."""
    words = image.view(np.int32)
    uwords = image.view(np.uint32)
    m, k0 = x.shape
    tiles = -(-m // 16)
    kch0 = -(-k0 // 32)
    xq = np.zeros((tiles * 16, 32 * kch0), np.int64)
    q = np.clip(np.rint(x / np.float32(s_in)), -128, 127)
    xq[:m, :k0] = q.astype(np.int64)
    a = _input_registers(xq.reshape(tiles, 16, -1), kch0)
    accs = []
    n_layers = int(words[2]) // 4  # the header ends where layer 0 starts
    for layer in range(n_layers):
        kch, nt, f_off, bs_off = (int(v) for v in words[4 * layer:4 * layer + 4])
        last = layer == n_layers - 1
        bias = words[bs_off:bs_off + 8 * nt].astype(np.int64)
        scale = words[bs_off + 8 * nt:bs_off + 16 * nt].view(np.float32)
        d_all = np.zeros((tiles, 32, nt, 4), np.int64)
        for j in range(nt):
            d = np.zeros((tiles, 16, 8), np.int64)
            for kc in range(kch):
                w0 = f_off + ((kc * nt + j) * 32) * 2
                b = _b_matrix(uwords[w0:w0 + 64].reshape(32, 2))
                d += _a_matrix(a[kc]) @ b
            d_all[:, :, j] = _d_fragment(d)
        # the accumulators back in (row, column) order
        acc = np.zeros((tiles, 16, 8 * nt), np.int64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j in range(nt):
                c = 8 * j + 2 * t
                acc[:, g, c:c + 2] = d_all[:, lane, j, 0:2]
                acc[:, g + 8, c:c + 2] = d_all[:, lane, j, 2:4]
        accs.append((acc + bias).reshape(-1, 8 * nt)[:m])
        y = _rescale(acc, bias, scale)
        if last:
            out = y.reshape(-1, 8 * nt)[:m, :out_dim]
            return (out if drow is None else out * drow), accs
        yq = np.clip(np.rint(y), 0, 127).astype(np.int64)
        # kChain: lane t's bytes of chunk oc are the columns it holds in the
        # D fragments of n8 tiles 4 oc .. 4 oc + 3
        n_chunks = -(-nt // 4)
        yq = np.concatenate([yq, np.zeros((tiles, 16, 32 * n_chunks - 8 * nt),
                                          np.int64)], axis=2)
        a = np.zeros((n_chunks, tiles, 32, 4), np.uint32)
        for oc in range(n_chunks):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                cols = [32 * oc + 16 * h + 8 * (qq >> 1) + 2 * t + (qq & 1)
                        for h in range(2) for qq in range(4)]
                a[oc, :, lane, 0] = _pack4(yq[:, g, cols[:4]])
                a[oc, :, lane, 1] = _pack4(yq[:, g + 8, cols[:4]])
                a[oc, :, lane, 2] = _pack4(yq[:, g, cols[4:]])
                a[oc, :, lane, 3] = _pack4(yq[:, g + 8, cols[4:]])


@pytest.mark.parametrize("m", [1, 7, 300])
def test_fused_kernel_emulation_reproduces_the_oracle(nets, m):
    """Reading the image as the kernel's fragment index arithmetic does
    gives the oracle's int32 accumulators, layer by layer, and its
    outputs; and the JAX package's eager int_forward."""
    ints, pints = nets
    x = np.random.default_rng(100 + m).normal(
        size=(m, 2 * N_FRAMES)).astype(np.float32)
    net = pops.prepad_int_layers(pints)
    got, accs = _emulate_fused(net.image.numpy(), x, net.s_in_host,
                               net.out_dim)
    assert len(accs) == net.n_layers
    h = pqat.quantize_input(torch.from_numpy(x), pints[0].s_in)
    for layer, acc in zip(pints, accs):
        n = layer.w_q.shape[1]
        want_acc = h.numpy().astype(np.int64) @ layer.w_q.numpy().astype(
            np.int64) + layer.b_q.numpy()
        np.testing.assert_array_equal(acc[:, :n], want_acc)
        assert not acc[:, n:].any()  # padded columns: zero weights and bias
        h = pqat.int8_dense(h, layer)
    want = pqat.int_forward(pints, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jqat.int_forward(ints, jnp.asarray(x))))
    got_ms, _ = _emulate_fused(net.image.numpy(), x, net.s_in_host,
                               net.out_dim, drow=DSCALE)
    np.testing.assert_array_equal(
        got_ms, pops.int_forward_fused(net, torch.from_numpy(x),
                                       denorm_scale=DSCALE).numpy())


@pytest.mark.parametrize("mkn", [(1024, 64, 64), (130, 200, 300), (1, 4, 4),
                                 (33, 72, 20), (5, 37, 13)])
@pytest.mark.parametrize("relu,float_out",
                         [(True, False), (False, False), (False, True)])
def test_qat_dense_kernel_emulation_matches_plain(mkn, relu, float_out):
    """qat_dense.cu's arithmetic on numpy: each block's slab of 16, 32 or 64
    columns as kInput-map B fragments (``fused.fragments``, which the
    kernel's 4 x 4 byte transpose writes), A registers from 8-byte row
    loads on the same map, 16-row tiles, the epilogue — equal to the plain
    version, ragged K, N and M included."""
    m, k, n = mkn
    x, w, b, s = _rand_case(m, k, n, seed=sum(mkn) + 1)
    n16 = -(-n // 16)
    slab = 16 * (1 if n16 <= 1 else 2 if n16 == 2 else 4)
    kch, tiles = -(-k // 32), -(-m // 16)
    rows8 = np.zeros((tiles * 16, 32 * kch), np.int64)
    rows8[:m, :k] = x
    a = _input_registers(rows8.reshape(tiles, 16, -1), kch)
    acc = np.zeros((tiles * 16, -(-n // slab) * slab), np.int64)
    for n0 in range(0, n, slab):
        wslab = np.zeros((k, slab), np.int8)
        wslab[:, :min(slab, n - n0)] = w[:, n0:n0 + slab]
        frags = pfused.fragments(wslab, chain=False).view(np.uint32)
        nt = slab // 8
        for j in range(nt):
            d = np.zeros((tiles, 16, 8), np.int64)
            for kc in range(kch):
                w0 = ((kc * nt + j) * 32) * 2
                d += _a_matrix(a[kc]) @ _b_matrix(frags[w0:w0 + 64].reshape(32, 2))
            acc[:, n0 + 8 * j:n0 + 8 * j + 8] = d.reshape(-1, 8)
    y = _rescale(acc[:m, :n], b.astype(np.int64), s)
    if not float_out:
        y = np.clip(np.rint(y), 0.0 if relu else -128.0, 127.0).astype(np.int8)
    want = pref.ref_qat_dense(*_t(x, w, b, s), relu=relu, float_out=float_out)
    np.testing.assert_array_equal(y, want.numpy())


def test_plain_int32_fallback_is_exact():
    """A layer too wide for exact fp32 accumulation takes the float64 path
    and still matches the integer reference."""
    case = _rand_case(3, 1100, 5, seed=3)
    assert not pops._f32_dot_is_exact(1100, float(np.abs(case[2]).max()))
    got = pops.qat_dense_lax(*_t(*case), relu=False)
    want = np.asarray(jref.ref_qat_dense(*map(jnp.asarray, case), relu=False))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch(nets):
    _, pints = nets
    net = pops.prepad_int_layers(pints)
    before = (pfused.fused_forward_call.launches,
              pkernel.qat_dense_call.launches)
    x = torch.zeros((4, 2 * N_FRAMES))
    pops.int_forward_fused(net, x)
    pops.int_forward_layered(net, x)
    assert (pfused.fused_forward_call.launches,
            pkernel.qat_dense_call.launches) == before

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
    """The packed image holds each layer's transposed weights, biases and
    scales where its header says."""
    _, pints = nets
    net = pops.prepad_int_layers(pints)
    words = net.image.numpy().view(np.int32)
    assert net.image.numel() % 16 == 0
    for i in range(net.n_layers):
        k_words, n, w_off, bs_off = words[4 * i:4 * i + 4]
        w, b, s = (t.numpy() for t in net.packed[3 * i:3 * i + 3])
        assert (k_words * 4, n) == w.shape
        rows = words[w_off:w_off + n * (k_words + 1)].reshape(n, k_words + 1)
        assert not rows[:, -1].any()  # the bank-staggering pad word
        np.testing.assert_array_equal(
            np.ascontiguousarray(rows[:, :-1]).view(np.int8), w.T)
        np.testing.assert_array_equal(words[bs_off:bs_off + n], b)
        np.testing.assert_array_equal(
            words[bs_off + n:bs_off + 2 * n].view(np.float32), s)
    assert net.act_words == max(max(w.shape) for w in net.packed[::3]) // 4
    assert pfused.smem_bytes(net.image.numel(), net.act_words) < 227 * 1024


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

"""Port parity: fused training (``kernels/fused_train``) against the JAX
package's Pallas kernels run in interpret mode, and against the port's own
autograd oracle, on identical numpy inputs.  On the CPU the port's wrappers
run the kernel's plain version (``ref.fused_train_plain``).

Tolerances: losses and params atol 1e-5 (the JAX package's own
kernel-vs-oracle tolerance); Adam's moments atol 1e-6, rtol 1e-5 (fp32 sum
order).  Inside the port a K-step launch equals K single-step launches,
and 4 + 4 + 2 steps equal 10, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_train import ops as jops
from repro.optim import optimizers as jopt
from repro_torch.convert import adam_state_from_numpy, params_from_numpy
from repro_torch.core import mrf_net
from repro_torch.kernels.fused_train import kernel as pkernel
from repro_torch.kernels.fused_train import ops as pops
from repro_torch.kernels.fused_train import ref as pref
from repro_torch.optim import optimizers as popt
from repro_torch.tree import leaves

SMALL = (32, 16)


def _case(n_frames=16, hidden=SMALL, batch=32, seed=0):
    sizes = mrf_net.layer_sizes(n_frames, hidden)
    rng = np.random.default_rng(seed)
    params = [{"w": (rng.uniform(-1, 1, (i, o)) * np.sqrt(6.0 / i)
                     ).astype(np.float32),
               "b": rng.normal(0, 0.05, (o,)).astype(np.float32)}
              for i, o in zip(sizes[:-1], sizes[1:])]
    x = rng.normal(size=(batch, sizes[0])).astype(np.float32)
    y = rng.uniform(size=(batch, 2)).astype(np.float32)
    return params, x, y


def _j(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


def _assert_params(got, want, atol=1e-5, rtol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(np.asarray(g[k].detach()),
                                       np.asarray(w[k]), atol=atol, rtol=rtol)


def _bitequal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y), float((x - y).abs().max())


@pytest.mark.parametrize("qat", [False, True])
@pytest.mark.parametrize("tile", [1, 8, 32])
def test_fused_train_step_matches_jax_and_oracle(tile, qat):
    params, x, y = _case()
    want_p, want_l = jops.fused_train_step(_j(params), jnp.asarray(x),
                                           jnp.asarray(y), lr=1e-2,
                                           tile_batch=tile, qat=qat)
    pp = params_from_numpy(params, "cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got_p, got_l = pops.fused_train_step(pp, xt, yt, lr=1e-2,
                                         tile_batch=tile, qat=qat)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5)
    _assert_params(got_p, want_p)
    orc_p, orc_l = pref.ref_train(pp, xt, yt, lr=1e-2, tile_batch=tile,
                                  qat=qat)
    np.testing.assert_allclose(got_l.numpy(), orc_l.numpy(), atol=1e-5)
    _assert_params(got_p, orc_p)


def test_full_width_mrf_fpga_step_matches_jax():
    params, x, y = _case(n_frames=32, hidden=mrf_net.ADAPTED_HIDDEN,
                         batch=16, seed=4)
    want_p, want_l = jops.fused_train_step(_j(params), jnp.asarray(x),
                                           jnp.asarray(y), lr=1e-2,
                                           tile_batch=8)
    got_p, got_l = pops.fused_train_step(params_from_numpy(params, "cpu"),
                                         torch.from_numpy(x),
                                         torch.from_numpy(y), lr=1e-2,
                                         tile_batch=8)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5)
    _assert_params(got_p, want_p)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_multistep_ragged_batch_matches_jax(optimizer):
    """K=3 steps of 24 rows with tile_batch 16: the tile degrades to 12."""
    k_steps, per_step, lr = 3, 24, 2e-3
    params, x, y = _case(batch=k_steps * per_step, seed=2)
    jo = getattr(jopt, optimizer)(lr)
    want_p, want_s, want_l = jops.fused_train_multistep(
        _j(params), jo.init(_j(params)), jnp.asarray(x), jnp.asarray(y),
        n_steps=k_steps, lr=lr, optimizer=optimizer, tile_batch=16)
    pp = params_from_numpy(params, "cpu")
    got_p, got_s, got_l = pops.fused_train_multistep(
        pp, getattr(popt, optimizer)(lr).init(pp), torch.from_numpy(x),
        torch.from_numpy(y), n_steps=k_steps, lr=lr, optimizer=optimizer,
        tile_batch=16)
    assert got_l.shape == want_l.shape == (k_steps, 2)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5)
    _assert_params(got_p, want_p)
    assert int(got_s.step) == int(want_s.step) == (
        k_steps * 2 if optimizer == "adam" else k_steps)
    if optimizer == "adam":
        _assert_params(got_s.mu, want_s.mu, atol=1e-6, rtol=1e-5)
        _assert_params(got_s.nu, want_s.nu, atol=1e-6, rtol=1e-5)


def _opt_state(optimizer, pp, lr):
    return popt.adam(lr).init(pp) if optimizer == "adam" else None


@pytest.mark.parametrize("qat", [False, True])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_k_step_launch_bitequals_k_single_steps(optimizer, qat):
    k_steps, per_step, lr = 4, 24, 2e-3
    params, x, y = _case(batch=k_steps * per_step, seed=3)
    pp = params_from_numpy(params, "cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    p_multi, s_multi, trace = pops.fused_train_multistep(
        pp, _opt_state(optimizer, pp, lr), xt, yt, n_steps=k_steps, lr=lr,
        optimizer=optimizer, tile_batch=8, qat=qat)
    p_seq, s_seq, rows = pp, _opt_state(optimizer, pp, lr), []
    for k in range(k_steps):
        sl = slice(k * per_step, (k + 1) * per_step)
        p_seq, s_seq, tl = pops.fused_train_multistep(
            p_seq, s_seq, xt[sl], yt[sl], n_steps=1, lr=lr,
            optimizer=optimizer, tile_batch=8, qat=qat)
        rows.append(tl[0])
    assert torch.equal(trace, torch.stack(rows))
    _bitequal(p_multi, p_seq)
    _bitequal(s_multi, s_seq)
    if optimizer == "sgd":  # B1 is the K=1 case of the same kernel
        p1, l1 = pops.fused_train_step(pp, xt[:per_step], yt[:per_step],
                                       lr=lr, tile_batch=8, qat=qat)
        p2, _, t2 = pops.fused_train_multistep(
            pp, None, xt[:per_step], yt[:per_step], n_steps=1, lr=lr,
            tile_batch=8, qat=qat)
        _bitequal(p1, p2)
        assert torch.equal(l1, t2[0])


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_ragged_chunks_bitequal_one_launch(optimizer):
    """4 + 4 + 2 launches == one 10-step launch: a restart on any chunk
    boundary resumes the same trajectory."""
    per_step, lr = 16, 1e-3
    params, x, y = _case(batch=10 * per_step, seed=5)
    pp = params_from_numpy(params, "cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    p_full, s_full, trace = pops.fused_train_multistep(
        pp, _opt_state(optimizer, pp, lr), xt, yt, n_steps=10, lr=lr,
        optimizer=optimizer, tile_batch=8)
    p, s, rows = pp, _opt_state(optimizer, pp, lr), []
    for lo, hi in ((0, 4), (4, 8), (8, 10)):
        sl = slice(lo * per_step, hi * per_step)
        p, s, tl = pops.fused_train_multistep(
            p, s, xt[sl], yt[sl], n_steps=hi - lo, lr=lr,
            optimizer=optimizer, tile_batch=8)
        rows.append(tl)
    assert torch.equal(trace, torch.cat(rows))
    _bitequal(p_full, p)
    _bitequal(s_full, s)


@pytest.mark.parametrize("qat", [False, True])
def test_stream_divergence_reads_where_two_runs_part(qat):
    """The per-sample stream check (``ref.stream_divergence``): against
    itself (the CPU wrapper is the plain version) it reads zero and
    reproduces one launch over the stream bit for bit; against an update
    with a 1% larger step it reads the error of one update, and with QAT
    the update where the int8 levels first differ."""
    params, x, y = _case(batch=32, seed=8)
    flat, widths = pops.pack_params(params_from_numpy(params, "cpu"))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def b1(lr):
        return lambda xr, yr, p: pkernel.fused_train_call(
            xr, yr, p, widths=widths, lr=lr, tile_batch=1, qat=qat)

    same = pref.stream_divergence(b1(1e-2), xt, yt, flat, widths, lr=1e-2,
                                  qat=qat)
    assert (same["local_err"], same["free_err"], same["end_err"],
            same["first_flip"], same["flipped"]) == (0.0, 0.0, 0.0, None, 0)
    one_p, one_l = b1(1e-2)(xt, yt, flat)
    assert torch.equal(same["params"], one_p)
    assert torch.equal(same["losses"], one_l)
    off = pref.stream_divergence(b1(1.01e-2), xt, yt, flat, widths,
                                 lr=1e-2, qat=qat)
    assert 0.0 < off["local_err"] < 1e-2 and off["end_err"] > 0.0
    if qat:
        assert off["first_flip"] is not None and off["flipped"] > 0
    else:
        assert off["first_flip"] is None and off["flipped"] == 0
        assert off["free_err"] >= off["end_err"]


def test_inputs_are_not_mutated():
    params, x, y = _case(batch=16, seed=6)
    pp = params_from_numpy(params, "cpu")
    state = adam_state_from_numpy(
        7, params, [{k: np.abs(v) for k, v in p.items()} for p in params],
        "cpu")
    before = [t.clone() for t in leaves((pp, state))]
    pops.fused_train_multistep(pp, state, torch.from_numpy(x),
                               torch.from_numpy(y), n_steps=2, lr=1e-2,
                               optimizer="adam", tile_batch=4, qat=True)
    _bitequal(before, leaves((pp, state)))


def test_pack_unpack_round_trip_and_effective_tile():
    params, _, _ = _case(n_frames=32, hidden=mrf_net.ORIGINAL_HIDDEN)
    pp = params_from_numpy(params, "cpu")
    flat, widths = pops.pack_params(pp)
    assert widths == mrf_net.layer_sizes(32, mrf_net.ORIGINAL_HIDDEN)
    assert flat.shape == (pref.packed_size(widths),) == (39_968 + 466,)
    _bitequal(pops.unpack_params(flat, widths), pp)
    # the JAX package's padded stacks hold the same values
    w_pad, b_pad = jops.pad_params(_j(params))
    for l, layer in enumerate(pops.unpack_params(flat, widths)):
        k, n = layer["w"].shape
        np.testing.assert_array_equal(layer["w"].numpy(),
                                      np.asarray(w_pad[l, :k, :n]))
        np.testing.assert_array_equal(layer["b"].numpy(),
                                      np.asarray(b_pad[l, :n]))
    for batch, tile in ((192, 128), (100, 128), (7, 4), (13, 8), (97, 128),
                        (254, 128), (96, 36), (256, 1), (24, 16)):
        assert pops.effective_tile(batch, tile) == jops.effective_tile(
            batch, tile)
    assert pops.effective_tile(254, 128) == 127


def _block_bytes(widths, rows):
    """Shared memory a block of the cluster kernel must have, counted from
    its layout: the plan's copy and two mbarriers (288 floats), each
    layer's W (rows padded to 4) and b, QAT's column scales, two x and two
    y row buffers, each hidden layer's activations and two delta buffers
    (rows 4 floats longer than the padded width), the loss terms and 4
    floats; each buffer of ``rows`` rounded up to the register tile (2
    rows, 1 at a single row)."""
    def pad(n):
        return -(-n // 4) * 4

    rpad = 1 if rows == 1 else -(-rows // 2) * 2
    p = [pad(w) for w in widths]
    net = sum(k * n + n for k, n in zip(p[:-1], p[1:])) + sum(p[1:])
    row = (2 * (p[0] + 4) + 2 * p[-1] + sum(n + 4 for n in p[1:-1])
           + 2 * (max(p[1:]) + 4) + p[-1])
    return 4 * (288 + net + rpad * row + 4)


@pytest.mark.parametrize("tile", [1, 4, 32, 127, 128, 256])
def test_shared_memory_budget_of_both_nets(tile):
    """The cluster kernel's per-block budget at the cluster the wrapper
    picks, for both nets: the replica, the block's rows and deltas (all of
    it required), then QAT's fake-quantized weights and the partial dW/db
    buffers where they fit; a net or a cluster whose required part exceeds
    a block is refused."""
    for hidden in (mrf_net.ADAPTED_HIDDEN, mrf_net.ORIGINAL_HIDDEN):
        widths = mrf_net.layer_sizes(32, hidden)
        c = pkernel.cluster_size(tile, widths)
        for qat in (False, True):
            plan = pkernel.train_plan(widths, tile, c, qat)
            assert plan.cluster == c and plan.rows == -(-tile // c)
            assert plan.required_bytes == _block_bytes(widths, plan.rows)
            assert plan.required_bytes <= plan.smem_bytes <= pkernel.SMEM_MAX
        for c in pkernel.cluster_sizes(tile, widths):
            assert pkernel.train_plan(widths, tile, c).required_bytes == (
                _block_bytes(widths, -(-tile // c)))
        for c in set((1, 2, 4, 8, 16)) - set(pkernel.cluster_sizes(
                tile, widths)):
            assert _block_bytes(widths, -(-tile // c)) > pkernel.SMEM_MAX
            with pytest.raises(ValueError, match="shared memory"):
                pkernel.train_plan(widths, tile, c)
    fpga = mrf_net.layer_sizes(32, mrf_net.ADAPTED_HIDDEN)
    original = mrf_net.layer_sizes(32, mrf_net.ORIGINAL_HIDDEN)
    if tile == 128:  # the training path's tile: 8 blocks of 16 rows
        assert pkernel.train_plan(fpga, 128, 8).required_bytes == 81_200
        qat_plan = pkernel.train_plan(fpga, 128, 8, True)
        assert qat_plan.smem_bytes == 219_264 and qat_plan.wq_in_smem
        assert qat_plan.bulk and all(qat_plan.part_in_smem)
        assert qat_plan.gws_stride == 0
        plan = pkernel.train_plan(original, 128, 8)
        assert plan.required_bytes == 223_024 and not plan.bulk
        assert pkernel.cluster_sizes(128, original) == (8, 16)
    with pytest.raises(ValueError, match="shared memory"):
        pkernel.cluster_size(tile, (64, 256, 256, 2))


def test_cluster_size_is_a_function_of_tile_and_widths():
    """The wrapper's cluster depends on the tile and the widths only (QAT,
    the optimizer and the number of tiles do not change it), so a K-step
    launch and K single-step launches sum in the same order: one block at
    tile 1 and up to 16 rows, then the fewest blocks (up to the portable 8)
    that leave at most 16 rows a block, more where the rows do not fit."""
    fpga = mrf_net.layer_sizes(32, mrf_net.ADAPTED_HIDDEN)
    original = mrf_net.layer_sizes(32, mrf_net.ORIGINAL_HIDDEN)
    want = {1: 1, 4: 1, 16: 1, 17: 2, 32: 2, 64: 4, 127: 8, 128: 8, 256: 8}
    for tile, c in want.items():
        assert pkernel.cluster_size(tile, fpga) == c
        assert pkernel.cluster_size(tile, fpga) == pkernel.cluster_size(
            tile, list(fpga))
    assert pkernel.cluster_size(128, original) == 8
    assert pkernel.cluster_size(256, original) == 16  # 32 rows do not fit
    for c in (0, 3, 12, 32):  # the kernel takes powers of two up to 16
        with pytest.raises(ValueError, match="cluster"):
            pkernel.train_plan(fpga, 128, c)
    for tile in (1, 8, 24, 128):
        for widths in (fpga, original):
            c = pkernel.cluster_size(tile, widths)
            assert c in pkernel.cluster_sizes(tile, widths)
            assert pkernel.train_plan(widths, tile, c, False).ints[:3] == (
                len(widths) - 1, c, tile)
            assert pkernel.train_plan(widths, tile, c, True).cluster == c


def test_wrappers_refuse_what_they_cannot_run():
    params, x, y = _case(batch=12)
    flat, widths = pops.pack_params(params_from_numpy(params, "cpu"))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with pytest.raises(ValueError, match="tiles"):
        pkernel.fused_train_call(xt, yt, flat, widths=widths, lr=1e-2,
                                 tile_batch=5)
    with pytest.raises(ValueError, match="moments and step0"):
        pkernel.run_fused_train(xt, yt, flat, widths, lr=1e-2, tile_batch=4,
                                moments=(flat, flat))
    with pytest.raises(ValueError, match="layers"):
        pkernel.fused_train_call(xt, yt, flat, widths=(32,), lr=1e-2,
                                 tile_batch=4)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pkernel.fused_train_call(torch.empty(x.shape, **meta),
                                 torch.empty(y.shape, **meta),
                                 torch.empty(flat.shape, **meta),
                                 widths=widths, lr=1e-2, tile_batch=4)
    with pytest.raises(ValueError, match="AdamState"):
        pops.fused_train_multistep(params_from_numpy(params, "cpu"), None,
                                   xt, yt, n_steps=1, lr=1e-2,
                                   optimizer="adam")
    with pytest.raises(ValueError, match="sgd"):
        pops.make_engine_step(lr=1e-2, optimizer="rmsprop")
    with pytest.raises(ValueError, match="n_steps"):
        pops.fused_train_multistep(params_from_numpy(params, "cpu"), None,
                                   xt, yt, n_steps=5, lr=1e-2)


def test_cpu_launches_count_nothing():
    """The counters count kernel launches; the plain version is not one."""
    params, x, y = _case(batch=8)
    pp = params_from_numpy(params, "cpu")
    from repro_torch.kernels.fused_train import multistep
    before = (pkernel.fused_train_call.launches,
              multistep.fused_train_multistep_call.launches,
              multistep.fused_train_adam_call.launches)
    pops.fused_train_step(pp, torch.from_numpy(x), torch.from_numpy(y),
                          lr=1e-2, tile_batch=4)
    pops.fused_train_multistep(pp, popt.adam(1e-3).init(pp),
                               torch.from_numpy(x), torch.from_numpy(y),
                               n_steps=2, lr=1e-3, optimizer="adam",
                               tile_batch=4)
    assert (pkernel.fused_train_call.launches,
            multistep.fused_train_multistep_call.launches,
            multistep.fused_train_adam_call.launches) == before

"""The slice as a whole: the port's serving stack (queue, wave executor,
engine, launcher) against the JAX package.

A JAX-exported int8 artifact served by the port's ``ReconEngine`` — every
int8 implementation, sync and pipelined, at mrf-fpga and mrf-original full
widths — must reproduce ``denormalize_targets(qat.int_forward(...))`` of
eager JAX bit for bit.  The float engine compares with JAX's under
rtol 1e-5 (the reference itself drifts by ~3e-6 between its own paths).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as jqat
from repro.data.pipeline import denormalize_targets as j_denorm
from repro.serve import executor as jexecutor
from repro.serve import recon as jrecon
from repro_torch.convert import params_from_numpy
from repro_torch.core import mrf_net as pnet
from repro_torch.core import qat as pqat
from repro_torch.launch import serve as plaunch
from repro_torch.serve import executor as pexecutor
from repro_torch.serve.queue import RequestQueue, RequestState
from repro_torch.serve.recon import ReconEngine, ReconRequest

HIDDEN = {"mrf-fpga": pnet.ADAPTED_HIDDEN, "mrf-original": pnet.ORIGINAL_HIDDEN}
IN_DIM = 64


def _np_params(hidden, seed=0):
    sizes = pnet.layer_sizes(32, hidden)
    rng = np.random.default_rng(seed)
    return [{"w": rng.uniform(-1, 1, (i, o)).astype(np.float32)
             * np.float32(np.sqrt(6.0 / i)),
             "b": rng.normal(0, 0.05, (o,)).astype(np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])]


def _jax_ints(params, seed=0):
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]
    x = np.random.default_rng(seed + 1).normal(size=(64, IN_DIM))
    qs = jqat.init_qat_state(len(jp))
    for _ in range(5):
        _, qs = jqat.forward_qat(jp, qs, jnp.asarray(x, jnp.float32))
    return jqat.export_int8(jp, qs)


@pytest.fixture(scope="module", params=sorted(HIDDEN))
def artifact(request, tmp_path_factory):
    """(arch, JAX int8 layers, path of the JAX-saved artifact)."""
    ints = _jax_ints(_np_params(HIDDEN[request.param]))
    path = jqat.save_int8_artifact(
        tmp_path_factory.mktemp("art") / request.param, ints)
    return request.param, ints, path


def _requests(seed=0):
    """Three masked slices of different sizes plus one flat request:
    1,651 voxels — a full 1024 tile and a ragged tail."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i, side in enumerate((30, 17, 9)):
        mask = rng.uniform(size=(side, side)) < 0.8
        feats = rng.normal(size=(int(mask.sum()), IN_DIM)).astype(np.float32)
        reqs.append(ReconRequest(torch.from_numpy(feats), mask, f"slice-{i}"))
    flat = rng.normal(size=(300, IN_DIM)).astype(np.float32)
    reqs.append(ReconRequest(torch.from_numpy(flat), None, "flat"))
    return reqs


def _oracle_ms(ints, feats):
    return np.asarray(j_denorm(jqat.int_forward(ints, jnp.asarray(
        feats.numpy()))))


@pytest.mark.parametrize("impl", ["fused", "layered", "lax"])
@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_slice_serves_jax_artifact_bitexact(artifact, impl, mode):
    _, ints, path = artifact
    engine = ReconEngine(backend="int8", mode=mode, int8_impl=impl,
                         max_wave_voxels=700, device="cpu",
                         int_layers=pqat.load_int8_artifact(path,
                                                            device="cpu"))
    reqs = _requests()
    results = engine.reconstruct(reqs)
    assert engine.last_wave["n_waves"] >= 2  # the voxel cap split the trace
    for r, got in zip(reqs, results):
        want = _oracle_ms(ints, r.features)
        if r.mask is None:
            np.testing.assert_array_equal(got.t1_ms, want[:, 0])
            np.testing.assert_array_equal(got.t2_ms, want[:, 1])
        else:
            np.testing.assert_array_equal(got.t1_ms[r.mask], want[:, 0])
            np.testing.assert_array_equal(got.t2_ms[r.mask], want[:, 1])
            assert not got.t1_ms[~r.mask].any()
        assert got.n_voxels == r.n_voxels and got.latency_s >= 0


def test_port_internal_equalities(artifact):
    """Every impl and mode serves identical maps; pooled == solo; the shape
    set stays bounded by the buckets."""
    _, _, path = artifact
    ints = pqat.load_int8_artifact(path, device="cpu")
    reqs = _requests(seed=3)
    base = ReconEngine(backend="int8", int_layers=ints, device="cpu")
    want = base.reconstruct(reqs)
    assert base.compile_cache_size() <= len(base.buckets)
    for impl in ("fused", "layered", "lax"):
        eng = ReconEngine(backend="int8", int_layers=ints, int8_impl=impl,
                          mode="pipelined", inflight_depth=3,
                          max_wave_voxels=256, device="cpu")
        tickets = []
        for r in reqs:
            tickets.append(eng.enqueue(r))
            eng.poll()
        eng.drain()
        assert all(t.state == RequestState.DONE for t in tickets)
        for t, w in zip(tickets, want):
            np.testing.assert_array_equal(t.result.t1_ms, w.t1_ms)
            np.testing.assert_array_equal(t.result.t2_ms, w.t2_ms)
    for r, w in zip(reqs, want):
        solo, = base.reconstruct([r])
        np.testing.assert_array_equal(solo.t1_ms, w.t1_ms)


def test_float_engine_matches_jax():
    params = _np_params(pnet.ADAPTED_HIDDEN, seed=4)
    reqs = _requests(seed=5)
    jeng = jrecon.ReconEngine(backend="float", params=[
        {k: jnp.asarray(v) for k, v in layer.items()} for layer in params])
    want = jeng.reconstruct([jrecon.ReconRequest(
        jnp.asarray(r.features.numpy()), r.mask, r.request_id) for r in reqs])
    got = ReconEngine(backend="float", params=params_from_numpy(params, "cpu"),
                      mode="pipelined", device="cpu").reconstruct(reqs)
    # rtol 1e-5 of each map's scale: random weights put some outputs near
    # zero by cancellation, where a per-element rtol means nothing
    for g, w in zip(got, want):
        for gm, wm in ((g.t1_ms, w.t1_ms), (g.t2_ms, w.t2_ms)):
            np.testing.assert_allclose(gm, wm, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(wm).max()))


@pytest.mark.parametrize("n", [0, 1, 127, 128, 1000, 1024, 1025, 5000])
def test_plan_tiles_matches_jax(n):
    for buckets in (pexecutor.DEFAULT_BUCKETS, (64, 192), (1000,)):
        assert pexecutor.plan_tiles(n, buckets) == \
            jexecutor.plan_tiles(n, buckets)


def test_bounded_solo_retry(artifact, monkeypatch):
    _, _, path = artifact
    eng = ReconEngine(backend="int8", device="cpu",
                      int_layers=pqat.load_int8_artifact(path, device="cpu"))
    real = eng.executor.dispatch
    calls = {"n": 0}

    def flaky(features, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return real(features, **kw)

    monkeypatch.setattr(eng.executor, "dispatch", flaky)
    reqs = _requests(seed=6)
    results = eng.reconstruct(reqs)  # each request retried alone, served
    assert len(results) == len(reqs) and eng.n_retries_total == len(reqs)
    assert calls["n"] == 1 + len(reqs)

    monkeypatch.setattr(eng.executor, "dispatch",
                        lambda f, **kw: (_ for _ in ()).throw(
                            RuntimeError("dead")))
    with pytest.raises(ValueError, match="after retry"):
        eng.reconstruct(reqs[:2])


def test_queue_forms_waves_by_cap_priority_and_deadline():
    now = [0.0]
    q = RequestQueue(max_wave_voxels=10, max_wait_ms=5.0,
                     clock=lambda: now[0])

    class Req:
        def __init__(self, n):
            self.n_voxels = n

    a, b, c = q.submit(Req(6)), q.submit(Req(6)), q.submit(Req(3), priority=1)
    assert q.wave_due()  # 15 voxels pending >= the cap of 10
    wave = q.form_wave()
    assert wave == [c, a]  # priority first, then FIFO; b does not fit
    assert q.n_pending == 1 and not q.wave_due()
    now[0] = 0.006  # b waited past max_wait_ms
    assert q.form_wave() == [b]
    assert all(t.state == RequestState.SCHEDULED for t in (a, b, c))
    bad = RequestQueue(validator=lambda r: "nope").submit(Req(1))
    assert bad.state == RequestState.FAILED and bad.error == "nope"


def test_launcher_serves_artifact_on_cpu(artifact, capsys):
    arch, _, path = artifact
    argv = ["--arch", arch, "--device", "cpu", "--artifact", str(path),
            "--phantom-n", "16", "--requests", "2"]
    assert plaunch.main(argv) == 0
    assert plaunch.main(argv + ["--serve-mode", "pipelined",
                                "--int8-impl", "layered"]) == 0
    out = capsys.readouterr().out
    assert out.count("oracle: bit-exact (2 requests)") == 2
    assert "pipelined == sync serving: bit-exact" in out
    # float weights and artifacts now come from training (see
    # test_torch_train.py); what the launcher still refuses:
    with pytest.raises(SystemExit, match="deployment unit"):
        plaunch.main(["--arch", arch, "--device", "cpu", "--backend",
                      "float", "--artifact", str(path)])
    with pytest.raises(SystemExit, match="requires --backend int8"):
        plaunch.main(["--arch", arch, "--device", "cpu", "--backend",
                      "float", "--int8-impl", "fused"])
    with pytest.raises(SystemExit, match="not an MRF serving backend"):
        plaunch.main(["--arch", arch, "--device", "cpu", "--backend", "fp8"])


def test_engine_read_only_surface_matches_jax(artifact):
    """The engine's views (``backend``, ``int_layers``, ``params``,
    ``request_sizes``, ``bucket_shapes_run``), the executor's recorded
    request sizes and an in-flight wave's ``n_tiles``, against the JAX
    engine serving the same requests (layer values bit for bit)."""
    _, ints, path = artifact
    reqs = _requests(seed=2)
    jeng = jrecon.ReconEngine(backend="int8", int_layers=ints,
                              max_wave_voxels=700)
    jeng.reconstruct([jrecon.ReconRequest(
        jnp.asarray(r.features.numpy()), r.mask, r.request_id) for r in reqs])
    eng = ReconEngine(backend="int8", max_wave_voxels=700, device="cpu",
                      int_layers=pqat.load_int8_artifact(path, device="cpu"))
    eng.reconstruct(reqs)
    assert eng.backend == jeng.backend == "int8"
    assert eng.params is None and jeng.params is None
    assert eng.request_sizes == jeng.request_sizes == \
        [r.n_voxels for r in reqs]
    assert eng.request_sizes is eng.executor.request_sizes
    assert eng.bucket_shapes_run == jeng.bucket_shapes_run
    assert len(eng.int_layers) == len(jeng.int_layers)
    for p, j in zip(eng.int_layers, jeng.int_layers):
        for f in ("w_q", "b_q", "s_in", "s_w", "s_out"):
            pv, jv = getattr(p, f), getattr(j, f)
            assert (pv is None) == (jv is None)
            if pv is not None:
                np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    feats = [r.features for r in reqs]
    pwave = eng.executor.dispatch(feats)
    jwave = jeng.executor.dispatch([jnp.asarray(f.numpy()) for f in feats])
    assert pwave.n_tiles == jwave.n_tiles == len(pwave.tiles) > 1
    pwave.wait()
    jwave.wait()
    assert eng.request_sizes[-len(reqs):] == [f.shape[0] for f in feats]


def test_float_engine_exposes_its_params():
    params = _np_params(pnet.ADAPTED_HIDDEN, seed=6)
    jeng = jrecon.ReconEngine(backend="float", params=[
        {k: jnp.asarray(v) for k, v in layer.items()} for layer in params])
    eng = ReconEngine(backend="float", params=params_from_numpy(params, "cpu"),
                      device="cpu")
    assert eng.backend == jeng.backend == "float"
    assert eng.int_layers is None and jeng.int_layers is None
    for p, j in zip(eng.params, jeng.params):
        for k in ("w", "b"):
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))
    assert eng.request_sizes == jeng.request_sizes == []

"""The serving robustness layer of the port against the JAX package's.

The same int8 artifact (numpy arrays; the JAX package calibrates and
exports it, ``repro_torch.convert`` hands it to the port) and the same
numpy-seeded requests go through the JAX ``ReconEngine`` and the port's
under the same fault schedule, ``AdmissionPolicy`` and an injected
stepping clock.  Per request id the terminal state, shed reason and retry
count agree, as do ``injector.fired``, every ``last_wave`` and
``health()``; the one mapped value is ``int8_impl`` after a breaker trip
(the reference's ``lax`` is the port's ``layered``: B4 gives way to B5),
and ``degraded_reason`` names each package's own implementations.  Every
map the port serves equals the eager ``repro.core.qat.int_forward`` oracle
bit for bit.  Then the properties of ``tests/test_serve_faults.py`` on the
port alone, and the chaos launcher on the CPU.
"""

import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as jqat
from repro.data.pipeline import denormalize_targets as j_denorm
from repro.serve import admission as jadmission
from repro.serve import faults as jfaults
from repro.serve import recon as jrecon
from repro_torch.convert import int_layers_from_numpy, params_from_numpy
from repro_torch.core import mrf_net as pnet
from repro_torch.core import qat as pqat
from repro_torch.launch import serve as plaunch
from repro_torch.serve import admission as padmission
from repro_torch.serve import faults as pfaults
from repro_torch.serve import recon as precon
from repro_torch.serve.admission import AdmissionPolicy, ShedReason
from repro_torch.serve.faults import FAULT_KINDS, FaultInjector, FaultSpec
from repro_torch.serve.queue import RequestState
from repro_torch.serve.recon import ReconEngine, ReconRequest

N_FRAMES = 16  # smoke width: (32, 64, 64, 32, 16, 16, 16, 2)
IN_DIM = 2 * N_FRAMES


def _np_params(seed=0):
    sizes = pnet.layer_sizes(N_FRAMES)
    rng = np.random.default_rng(seed)
    return [{"w": rng.uniform(-1, 1, (i, o)).astype(np.float32)
             * np.float32(np.sqrt(6.0 / i)),
             "b": rng.normal(0, 0.05, (o,)).astype(np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])]


@pytest.fixture(scope="module")
def jints():
    """The JAX package's int8 export of a numpy-seeded, calibrated net."""
    jp = [{k: jnp.asarray(v) for k, v in layer.items()}
          for layer in _np_params()]
    x = np.random.default_rng(1).normal(size=(64, IN_DIM))
    qs = jqat.init_qat_state(len(jp))
    for _ in range(3):
        _, qs = jqat.forward_qat(jp, qs, jnp.asarray(x, jnp.float32))
    return jqat.export_int8(jp, qs)


@pytest.fixture(scope="module")
def pints(jints):
    return int_layers_from_numpy(
        [{f: (None if getattr(layer, f) is None
              else np.asarray(getattr(layer, f)))
          for f in ("w_q", "b_q", "s_in", "s_w", "s_out")}
         for layer in jints], device="cpu")


def _features(n, seed):
    return np.random.default_rng(1000 + seed).normal(
        size=(n, IN_DIM)).astype(np.float32)


def _oracle_ms(jints, feats):
    """Eager JAX integer oracle, the common yardstick of both packages.
    Rows are independent, so the features ride in a block of 256 rows: eager
    JAX compiles each op once a shape, not once a request size."""
    n = feats.shape[0]
    block = np.zeros((-(-n // 256) * 256, IN_DIM), np.float32)
    block[:n] = feats
    out = j_denorm(jqat.int_forward(jints, jnp.asarray(block)))
    return np.asarray(out)[:n]


class StepClock:
    """Advances 1 ms a call: both engines see the same times as long as
    they read the clock at the same points."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _replay(pkg, ints, feats, ops, *, schedule, admission, **kw):
    """Run one engine of ``pkg`` ("jax" or "torch") through ``ops``: a list
    of ("enqueue", i, priority, deadline_ms) / ("poll",) / ("drain",).
    Returns (engine, tickets by request id, injector, [last_wave a drain])."""
    if pkg == "jax":
        faults, adm, recon = jfaults, jadmission, jrecon
        make, extra = jnp.asarray, {}
    else:
        faults, adm, recon = pfaults, padmission, precon
        make, extra = torch.from_numpy, {"device": "cpu"}
    injector = faults.FaultInjector(schedule)
    # small buckets: several tiles a wave, two shapes for JAX to compile
    eng = recon.ReconEngine(
        backend="int8", int_layers=ints, injector=injector, buckets=(64, 128),
        admission=(adm.AdmissionPolicy(**admission) if admission is not None
                   else None), clock=StepClock(), **kw, **extra)
    tickets, waves = {}, []
    for op in ops:
        if op[0] == "enqueue":
            _, i, prio, deadline = op
            req = recon.ReconRequest(make(feats[i]), None, f"r{i}")
            tickets[req.request_id] = eng.enqueue(req, priority=prio,
                                                  deadline_ms=deadline)
        elif op[0] == "poll":
            eng.poll()
        else:
            eng.drain()
            waves.append(dict(eng.last_wave))
    return eng, tickets, injector, waves


def _assert_parity(jints, pints, feats, ops, *, schedule, admission=None,
                   **kw):
    je, jt, jinj, jwaves = _replay("jax", jints, feats, ops,
                                   schedule=schedule, admission=admission,
                                   **kw)
    pe, pt, pinj, pwaves = _replay("torch", pints, feats, ops,
                                   schedule=schedule, admission=admission,
                                   **kw)
    assert sorted(jt) == sorted(pt)
    for rid in jt:
        j, p = jt[rid], pt[rid]
        assert (p.state, p.shed_reason, p.retries) == \
            (j.state, j.shed_reason, j.retries), rid
        assert p.state in RequestState.TERMINAL
        assert (p.error is None) == (j.error is None), rid
    assert pinj.fired == jinj.fired
    assert pwaves == jwaves
    jh, ph = je.health(), pe.health()
    assert (jh.pop("degraded_reason") is None) == \
        (ph.pop("degraded_reason") is None)
    if jh["degraded"]:
        assert (jh["int8_impl"], ph["int8_impl"]) == ("lax", "layered")
        jh["int8_impl"] = ph["int8_impl"]
    assert ph == jh
    # the port's maps against the eager oracle, bit for bit
    served = [t for t in pt.values() if t.state == RequestState.DONE]
    for t in served:
        want = _oracle_ms(jints, t.request.features.numpy())
        np.testing.assert_array_equal(t.result.t1_ms, want[:, 0])
        np.testing.assert_array_equal(t.result.t2_ms, want[:, 1])
    return pe, pt, pinj


def _random_case(seed):
    """A random schedule over every fault kind, knobs and arrivals, as the
    reference's chaos property draws them."""
    rng = random.Random(seed)
    n = 5
    sizes = [rng.randint(30, 150) for _ in range(n)]
    sched = []
    for _ in range(rng.randint(1, 4)):
        kind = rng.choice(FAULT_KINDS)
        if (kind in ("kernel_fail", "tile_timeout", "slow_wave")
                or rng.random() < 0.5):
            sched.append({"kind": kind, "wave": rng.randrange(5)})
        else:
            sched.append({"kind": kind, "request_id": f"r{rng.randrange(n)}"})
    mode = rng.choice(["sync", "pipelined"])
    kw = dict(mode=mode, int8_impl=rng.choice(["fused", "lax"]),
              max_wave_voxels=rng.choice([None, 128, 256]),
              wave_timeout_s=rng.choice([None, 0.004]),
              adaptive=mode == "pipelined" and rng.random() < 0.5)
    admission = (dict(max_pending_voxels=rng.choice([250, 400]),
                      displace=rng.random() < 0.5)
                 if rng.random() < 0.6 else None)
    ops = [("enqueue", i, rng.randint(0, 1), None) for i in range(n)]
    ops += [("drain",)]
    feats = [_features(s, seed * 10 + i) for i, s in enumerate(sizes)]
    return feats, ops, sched, admission, kw


@pytest.mark.parametrize("seed", range(8))
def test_engine_matches_jax_under_random_chaos(jints, pints, seed):
    feats, ops, sched, admission, kw = _random_case(seed)
    _assert_parity(jints, pints, feats, ops, schedule=sched,
                   admission=admission, **kw)


SCENARIOS = {
    # the chip smoke's schedule at a small size: every kind fires, the
    # breaker trips on a solo retry wave, the poisoned request fails alone
    "every-kind-adaptive": dict(
        sizes=[60] * 8, budget=240, kw=dict(
            mode="pipelined", int8_impl="fused", max_wave_voxels=120,
            adaptive=True, wave_timeout_s=1.0),
        schedule=[{"kind": "dispatch_raise", "wave": 0},
                  {"kind": "kernel_fail", "wave": 2},
                  {"kind": "tile_timeout", "wave": 3},
                  {"kind": "slow_wave", "wave": 4, "delay_s": 0.5},
                  {"kind": "assembly_corrupt", "request_id": "r3"}]),
    # streaming: faults land during poll-driven dispatch
    "streaming-poll": dict(
        sizes=[100] * 4, budget=None, stream=True, kw=dict(
            mode="pipelined", int8_impl="fused", max_wave_voxels=128,
            max_wait_ms=0.0),
        schedule=[{"kind": "dispatch_raise", "wave": 0},
                  {"kind": "tile_timeout", "wave": 2},
                  {"kind": "kernel_fail", "wave": 3}]),
    # sync mode, tile-by-tile retirement, a timeout that is no kernel fault
    "sync-timeout": dict(
        sizes=[700, 40, 90], budget=None, kw=dict(
            mode="sync", int8_impl="fused", max_wave_voxels=800,
            wave_timeout_s=0.002),
        schedule=[{"kind": "tile_timeout", "wave": 0},
                  {"kind": "assembly_corrupt", "wave": 1}]),
    # no retries at all: a failed wave fails its tickets
    "no-retries": dict(
        sizes=[40, 50, 60], budget=None, kw=dict(
            mode="sync", int8_impl="lax", max_retries=0),
        schedule=[{"kind": "dispatch_raise", "wave": 0},
                  {"kind": "kernel_fail", "wave": 1}]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax_in_named_scenarios(jints, pints, name):
    sc = SCENARIOS[name]
    feats = [_features(n, i) for i, n in enumerate(sc["sizes"])]
    ops = []
    for i in range(len(feats)):
        ops.append(("enqueue", i, 0, None))
        if sc.get("stream"):
            ops.append(("poll",))
    ops.append(("drain",))
    admission = (None if sc["budget"] is None
                 else dict(max_pending_voxels=sc["budget"]))
    pe, pt, pinj = _assert_parity(jints, pints, feats, ops,
                                  schedule=sc["schedule"],
                                  admission=admission, **sc["kw"])
    if name == "every-kind-adaptive":
        assert {k for _, k in pinj.fired} == set(FAULT_KINDS)
        assert [rid for rid, t in pt.items()
                if t.state == RequestState.FAILED] == ["r3"]
        assert pe.health()["degraded"] and pe.health()["n_shed_total"] == 4


def test_admission_shedding_matches_jax(jints, pints):
    """Deadline shedding against the observed rate, priority displacement
    and queue-full shedding over two drains of one engine."""
    feats = [_features(n, i) for i, n in enumerate([80, 80, 60, 90, 70, 50])]
    ops = [("enqueue", 0, 0, None), ("enqueue", 1, 0, None), ("drain",),
           # the service rate is known now: deadline-aware rejection
           ("enqueue", 2, 0, None), ("enqueue", 3, 0, 1e-6),
           ("enqueue", 4, 1, None), ("enqueue", 5, 0, 500.0), ("drain",)]
    pe, pt, _ = _assert_parity(
        jints, pints, feats, ops, schedule=[],
        admission=dict(max_pending_voxels=120, deadline_ms=1e4),
        mode="sync", int8_impl="fused")
    reasons = {rid: t.shed_reason for rid, t in pt.items()}
    assert reasons["r3"] == ShedReason.DEADLINE
    assert reasons["r2"] == ShedReason.DISPLACED
    assert ShedReason.QUEUE_FULL in reasons.values()
    assert pe.health()["service_rate_voxels_per_s"] > 0


# --------------------------------------------------------------------------
# the properties of tests/test_serve_faults.py, on the port alone
# --------------------------------------------------------------------------

def _engine(pints, **kw):
    kw.setdefault("int8_impl", "fused")
    return ReconEngine(backend="int8", int_layers=pints, device="cpu", **kw)


def _reqs(sizes, prefix="r", seed=0):
    return [ReconRequest(torch.from_numpy(_features(n, seed + i)), None,
                         f"{prefix}{i}") for i, n in enumerate(sizes)]


def _healthy(pints, req):
    res, = _engine(pints, int8_impl="fused").reconstruct([req])
    return res


@pytest.mark.parametrize("seed", range(4))
def test_every_ticket_ends_exactly_once_and_degraded_maps_equal_healthy(
        pints, seed):
    """Any schedule: drain terminates, every ticket ends in exactly one
    terminal state, served maps equal healthy fused serving bit for bit
    (degraded ones too), and the engine still serves afterwards."""
    rng = random.Random(100 + seed)
    reqs = _reqs([rng.randint(30, 400) for _ in range(6)], f"c{seed}_",
                 seed=50 * seed)
    sched = [FaultSpec(kind="kernel_fail", wave=0)]
    for _ in range(rng.randint(1, 4)):
        kind = rng.choice(FAULT_KINDS)
        if kind in ("kernel_fail", "tile_timeout", "slow_wave") or \
                rng.random() < 0.5:
            sched.append(FaultSpec(kind=kind, wave=rng.randrange(1, 6)))
        else:
            sched.append(FaultSpec(kind=kind,
                                   request_id=rng.choice(reqs).request_id))
    mode = rng.choice(["sync", "pipelined"])
    inj = FaultInjector(sched)
    eng = _engine(pints, mode=mode, max_wave_voxels=rng.choice([None, 256]),
                  adaptive=mode == "pipelined", injector=inj,
                  admission=AdmissionPolicy(max_pending_voxels=1200))
    tickets = [eng.enqueue(r, priority=rng.randint(0, 1)) for r in reqs]
    eng.drain()
    assert all(t.state in RequestState.TERMINAL for t in tickets)
    assert eng.queue.n_pending == 0 and not eng._inflight
    for t in tickets:
        if t.state == RequestState.DONE:
            want = _healthy(pints, t.request)
            np.testing.assert_array_equal(t.result.t1_ms, want.t1_ms)
            np.testing.assert_array_equal(t.result.t2_ms, want.t2_ms)
        elif t.state == RequestState.FAILED:
            assert t.error and t.result is None
        else:
            assert t.shed_reason in ShedReason.ALL and t.result is None
    stats = eng.last_wave
    assert (stats["n_requests"], stats["n_failed"], stats["n_shed"]) == tuple(
        sum(t.state == s for t in tickets) for s in RequestState.TERMINAL)
    # a poisoned request's dispatch_raise in wave 0 keeps the kernel_fail
    # from firing there
    tripped = any(k == "kernel_fail" for _, k in inj.fired)
    assert eng.health()["degraded"] == tripped
    assert (eng.executor.tiles_by_impl["layered"] > 0) == tripped
    n_fired = len(inj.fired)
    after = eng.enqueue(_reqs([64], "after", seed=999)[0])
    eng.drain()
    # served, unless a fault still armed for a later wave hit it
    assert after.state == RequestState.DONE or len(inj.fired) > n_fired


def test_breaker_trips_fused_to_layered_bit_exact(pints):
    eng = _engine(pints, injector=FaultInjector(
        [FaultSpec(kind="kernel_fail", wave=1)]))
    first = eng.reconstruct(_reqs([200]))
    assert not eng.health()["degraded"]
    reqs = _reqs([40, 1500], seed=7)
    results = eng.reconstruct(reqs)  # the failing tile re-runs on B5
    h = eng.health()
    assert h["degraded"] and h["int8_impl"] == "layered"
    assert "B4" in h["degraded_reason"] and "B5" in h["degraded_reason"]
    assert (h["n_kernel_failures"], h["n_retries_total"]) == (1, 0)
    assert h["n_degraded_waves"] == 1 and eng.last_wave["degraded"]
    assert dict(eng.executor.tiles_by_impl) == {"fused": 1, "layered": 2}
    for r, got in zip(reqs, results):
        want = _healthy(pints, r)
        np.testing.assert_array_equal(got.t1_ms, want.t1_ms)
        np.testing.assert_array_equal(got.t2_ms, want.t2_ms)
    assert first[0].n_voxels == 200


@pytest.mark.parametrize("backend", ["float", "layered", "lax"])
def test_kernel_fail_without_fallback_takes_the_retry_path(pints, backend):
    if backend == "float":
        eng = ReconEngine(backend="float", device="cpu",
                          params=params_from_numpy(_np_params(), "cpu"),
                          injector=FaultInjector(
                              [FaultSpec(kind="kernel_fail", wave=0)]))
    else:
        eng = _engine(pints, int8_impl=backend, injector=FaultInjector(
            [FaultSpec(kind="kernel_fail", wave=0)]))
    tickets = [eng.enqueue(r) for r in _reqs([40, 50])]
    eng.drain()
    assert all(t.state == RequestState.DONE for t in tickets)
    h = eng.health()
    assert not h["degraded"] and h["degraded_reason"] is None
    assert (h["n_kernel_failures"], h["n_retries_total"]) == (1, 2)


def test_failure_at_the_wave_wait_feeds_the_breaker(pints, monkeypatch):
    """A kernel's failure can surface at the event sync after the wave; the
    engine reports it, the breaker trips and the retries serve on B5."""
    eng = _engine(pints, mode="pipelined")
    real = eng.executor.dispatch
    calls = {"n": 0}

    def failing_wait(*a, **k):
        handle = real(*a, **k)
        calls["n"] += 1
        if calls["n"] == 1:
            def boom():
                raise RuntimeError("CUDA error: an illegal memory access")
            handle.wait = boom
        return handle

    monkeypatch.setattr(eng.executor, "dispatch", failing_wait)
    tickets = [eng.enqueue(r) for r in _reqs([40, 50])]
    eng.drain()
    assert all(t.state == RequestState.DONE for t in tickets)
    h = eng.health()
    assert h["degraded"] and h["n_kernel_failures"] == 1
    assert h["n_retries_total"] == 2
    assert eng.executor.tiles_by_impl["layered"] == 2


def test_a_failure_that_persists_after_the_trip_fails_through_retry(
        pints, monkeypatch):
    """A sticky device error breaks B5 too: nothing is hidden, the tickets
    fail after their retry and health() shows every failure."""
    eng = _engine(pints)

    def dead(x):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(eng.executor, "_fwd", dead)
    monkeypatch.setattr(eng.executor, "_make_forward", lambda: dead)
    tickets = [eng.enqueue(r) for r in _reqs([40, 50])]
    eng.drain()
    assert all(t.state == RequestState.FAILED for t in tickets)
    assert all("after retry" in t.error for t in tickets)
    h = eng.health()
    # the trip, its re-run on B5, then each ticket's solo retry
    assert h["degraded"] and h["n_kernel_failures"] == 3


def test_breaker_threshold_counts_failures(pints):
    eng = _engine(pints, injector=FaultInjector(
        [FaultSpec(kind="kernel_fail", wave=0)]))
    eng.executor.breaker_threshold = 2
    tickets = [eng.enqueue(r) for r in _reqs([40])]
    eng.drain()
    assert tickets[0].state == RequestState.DONE
    assert not eng.health()["degraded"]  # one failure of two: retried
    assert eng.executor.note_kernel_failure()  # the second trips it
    with pytest.raises(ValueError, match="breaker_threshold"):
        type(eng.executor)(backend="int8", int_layers=pints, device="cpu",
                           breaker_threshold=0)


def test_constructor_validation(pints):
    with pytest.raises(ValueError, match="pipelined"):
        _engine(pints, mode="sync", adaptive=True)
    with pytest.raises(ValueError, match="retry_backoff_s"):
        _engine(pints, retry_backoff_s=-1.0)
    eng = _engine(pints, mode="pipelined", adaptive=True,
                  max_wave_voxels=1000)
    assert eng.controller.wave_voxels == 896  # snapped onto the lane grid
    assert eng.controller.max_wave_voxels == 4000


def test_retry_backoff_sleeps_before_the_retry(pints, monkeypatch):
    slept = []
    monkeypatch.setattr("repro_torch.serve.recon.time.sleep", slept.append)
    eng = _engine(pints, retry_backoff_s=0.25, injector=FaultInjector(
        [FaultSpec(kind="dispatch_raise", wave=0)]))
    tickets = [eng.enqueue(r) for r in _reqs([40, 50])]
    eng.drain()
    assert all(t.state == RequestState.DONE for t in tickets)
    assert slept == [0.25]


def test_reconstruct_raises_on_shed_requests(pints):
    eng = _engine(pints, admission=AdmissionPolicy(max_pending_voxels=100,
                                                   displace=False))
    with pytest.raises(ValueError, match="shed"):
        eng.reconstruct(_reqs([80, 80]))
    assert eng.last_wave["n_shed"] == 1 and eng.health()["n_shed_total"] == 1


# --------------------------------------------------------------------------
# the chaos launcher on the CPU
# --------------------------------------------------------------------------

CHAOS_SCHEDULE = ('[{"kind": "dispatch_raise", "wave": 0}, '
                  '{"kind": "kernel_fail", "wave": 2}, '
                  '{"kind": "tile_timeout", "wave": 3}, '
                  '{"kind": "slow_wave", "wave": 4}, '
                  '{"kind": "assembly_corrupt", "request_id": "slice-3"}]')


@pytest.fixture(scope="module")
def artifact_path(pints, tmp_path_factory):
    return pqat.save_int8_artifact(tmp_path_factory.mktemp("art") / "net",
                                   pints)


def _chaos(path, *extra):
    # phantom 32: 544 tissue voxels a slice; two slices a wave, four of
    # the eight admitted
    return ["--arch", "mrf-fpga", "--smoke", "--device", "cpu",
            "--artifact", str(path), "--phantom-n", "32", "--requests", "8",
            "--serve-mode", "pipelined", "--max-wave-voxels", "1088",
            "--max-pending-voxels", "2176", *extra]


def test_chaos_launcher_passes_its_expectations(artifact_path, capsys):
    argv = _chaos(artifact_path, "--fault-schedule", CHAOS_SCHEDULE,
                  "--adaptive", "--wave-timeout-ms", "1000",
                  "--expect-shed", "--expect-degraded")
    assert plaunch.main(argv) == 0
    out = capsys.readouterr().out
    assert "oracle: bit-exact (3 requests)" in out
    assert "healthy serving on layered: bit-exact" in out
    rep = json.loads(out.splitlines()[-1].split(" ", 1)[1])
    assert (rep["n_done"], rep["n_failed"], rep["n_shed"]) == (3, 1, 4)
    assert rep["failed_ids"] == ["slice-3"] and rep["degraded"]
    assert {k for _, k in rep["fired"]} == set(FAULT_KINDS)
    assert rep["n_slow_waves"] >= 1 and rep["n_kernel_failures"] == 1
    assert rep["chaos_tiles_by_impl"]["fused"] >= 1


@pytest.mark.parametrize("unmet", ["--expect-degraded", "--expect-shed"])
def test_chaos_launcher_fails_an_unmet_expectation(artifact_path, capsys,
                                                   unmet):
    argv = _chaos(artifact_path, unmet)
    argv[argv.index("--requests") + 1] = "2"  # two slices: nothing shed
    assert plaunch.main(argv) == 1
    assert "FAIL: " + unmet in capsys.readouterr().out


def test_chaos_launcher_float_takes_the_retry_path(capsys):
    argv = ["--arch", "mrf-fpga", "--smoke", "--device", "cpu", "--backend",
            "float", "--train-steps", "5", "--phantom-n", "16",
            "--requests", "3", "--fault-schedule",
            '[{"kind": "kernel_fail", "wave": 0}]']
    assert plaunch.main(argv) == 0
    out = capsys.readouterr().out
    assert "healthy serving on float: within 1e-5 (3 requests)" in out
    rep = json.loads(out.splitlines()[-1].split(" ", 1)[1])
    assert not rep["degraded"] and rep["n_kernel_failures"] == 1
    assert (rep["n_done"], rep["retries"]) == (3, 3)
    assert plaunch.main(argv + ["--expect-degraded"]) == 1

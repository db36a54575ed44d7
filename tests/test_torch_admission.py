"""The serving layer's host-side policies of the port against the JAX
package's: fault specs and the injector (``serve.faults``), load shedding
in the queue (``serve.queue`` with ``serve.admission.AdmissionPolicy``) and
the adaptive pipelining controller.  Both packages get the same synthetic
arrivals and timings from a numpy seed and must decide alike; then the
rules of ``tests/test_serve_faults.py`` on the port alone.
"""

import dataclasses

import numpy as np
import pytest

from repro.serve import admission as jadmission
from repro.serve import faults as jfaults
from repro.serve import queue as jqueue
from repro_torch.ft.straggler import Ewma
from repro_torch.serve import admission as padmission
from repro_torch.serve import faults as pfaults
from repro_torch.serve import queue as pqueue
from repro_torch.serve.admission import (LANE, AdaptiveController,
                                         AdmissionPolicy, ShedReason)
from repro_torch.serve.faults import (FAULT_KINDS, FaultInjector, FaultSpec,
                                      InjectedServeFault, WaveTimeout)
from repro_torch.serve.queue import RequestQueue, RequestState


@dataclasses.dataclass(frozen=True)
class FakeReq:
    n_voxels: int
    request_id: str = ""


def test_constants_match_jax():
    assert FAULT_KINDS == jfaults.FAULT_KINDS
    assert ShedReason.ALL == jadmission.ShedReason.ALL
    assert LANE == jadmission.LANE
    assert RequestState.TERMINAL == jqueue.RequestState.TERMINAL


# --------------------------------------------------------------------------
# faults
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw, match", [
    (dict(kind="nope", wave=0), "not in"),
    (dict(kind="dispatch_raise"), "exactly one"),
    (dict(kind="dispatch_raise", wave=0, request_id="r"), "exactly one"),
    (dict(kind="kernel_fail", request_id="r"), "wave="),
    (dict(kind="tile_timeout", request_id="r"), "wave="),
    (dict(kind="slow_wave", request_id="r"), "wave="),
])
def test_faultspec_validation_matches_jax(kw, match):
    for mod in (pfaults, jfaults):
        with pytest.raises(ValueError, match=match):
            mod.FaultSpec(**kw)


def _fire(mod, injector, call, wave, rid):
    """One injection point of ``mod``'s injector; returns what a caller
    sees."""
    try:
        if call == "dispatch":
            injector.fire_dispatch(wave, [rid, "x"])
        elif call == "kernel":
            injector.fire_kernel(wave)
        elif call == "wait":
            spec = injector.fire_wait(wave)
            return ("slow", spec.delay_s) if spec is not None else None
        else:
            injector.fire_assemble(wave, rid)
    except mod.WaveTimeout as e:
        return ("timeout", str(e))
    except mod.InjectedServeFault as e:
        return ("raise", str(e))
    return None


@pytest.mark.parametrize("seed", range(4))
def test_injector_matches_jax_on_a_random_stream(seed):
    rng = np.random.default_rng(seed)
    sched = []
    for _ in range(8):
        kind = FAULT_KINDS[rng.integers(len(FAULT_KINDS))]
        if kind in ("kernel_fail", "tile_timeout", "slow_wave") or \
                rng.random() < 0.5:
            sched.append({"kind": kind, "wave": int(rng.integers(6)),
                          "delay_s": float(rng.uniform(0, 1))})
        else:
            sched.append({"kind": kind, "request_id": f"r{rng.integers(3)}"})
    p, j = pfaults.FaultInjector(sched), jfaults.FaultInjector(sched)
    for _ in range(60):
        call = ("dispatch", "kernel", "wait", "assemble")[rng.integers(4)]
        wave, rid = int(rng.integers(6)), f"r{rng.integers(4)}"
        assert _fire(pfaults, p, call, wave, rid) == \
            _fire(jfaults, j, call, wave, rid)
        assert p.n_armed() == j.n_armed()
    assert p.fired == j.fired and p.fired


def test_injector_one_shot_vs_persistent():
    inj = FaultInjector([FaultSpec(kind="dispatch_raise", wave=1),
                         {"kind": "dispatch_raise", "request_id": "bad"}])
    assert inj.n_armed() == 2
    inj.fire_dispatch(0, ["a"])  # the wave-1 spec does not fire at wave 0
    with pytest.raises(InjectedServeFault):
        inj.fire_dispatch(1, ["a"])
    assert inj.n_armed() == 1  # a wave spec is one-shot
    inj.fire_dispatch(1, ["a"])
    for w in (2, 3):  # a request spec fires on every wave holding "bad"
        with pytest.raises(InjectedServeFault, match="bad"):
            inj.fire_dispatch(w, ["bad", "a"])
    assert inj.fired == [(1, "dispatch_raise"), (2, "dispatch_raise"),
                         (3, "dispatch_raise")]
    waits = FaultInjector([FaultSpec(kind="tile_timeout", wave=0),
                           FaultSpec(kind="slow_wave", wave=1, delay_s=2.5)])
    with pytest.raises(WaveTimeout):
        waits.fire_wait(0)
    assert waits.fire_wait(1).delay_s == 2.5 and waits.fire_wait(2) is None


# --------------------------------------------------------------------------
# load shedding in the queue
# --------------------------------------------------------------------------

def _queue_trace(mods, seed):
    """Random arrivals, waves, retries and service observations through a
    queue with an admission policy; returns what happened, step by step."""
    adm, queue = mods
    rng = np.random.default_rng(seed)
    policy = adm.AdmissionPolicy(
        max_pending_voxels=int(rng.integers(200, 600)),
        deadline_ms=float(rng.uniform(5, 50)), displace=bool(rng.integers(2)))
    q = queue.RequestQueue(max_wave_voxels=int(rng.integers(100, 300)),
                           admission=policy, clock=lambda: 0.0)
    tickets, log = [], []
    for i in range(40):
        op = rng.integers(4)
        if op <= 1:
            deadline = (None if rng.random() < 0.7
                        else float(rng.uniform(1, 30)))
            t = q.submit(FakeReq(int(rng.integers(1, 200)), f"r{i}"),
                         priority=int(rng.integers(3)), deadline_ms=deadline)
            tickets.append(t)
        elif op == 2:
            wave = q.form_wave(flush=True)
            log.append([t.request.request_id for t in wave])
            if wave and rng.random() < 0.3:  # the wave failed: requeue
                for t in wave:
                    t.retries += 1
                    t.solo = True
                    q.requeue(t)
        else:
            policy.observe_service(int(rng.integers(0, 5000)),
                                   float(rng.uniform(0, 0.2)))
        log.append((q.pending_voxels(), q.n_pending, q.n_shed,
                    policy.service_rate))
    log.append([(t.request.request_id, t.state, t.shed_reason, t.error)
                for t in tickets])
    return log


@pytest.mark.parametrize("seed", range(6))
def test_queue_with_admission_matches_jax(seed):
    assert _queue_trace((padmission, pqueue), seed) == \
        _queue_trace((jadmission, jqueue), seed)


def test_queue_full_shed():
    q = RequestQueue(admission=AdmissionPolicy(max_pending_voxels=150,
                                               displace=False))
    t1, t2, t3 = (q.submit(FakeReq(n)) for n in (100, 100, 50))
    assert t1.state == RequestState.PENDING
    assert (t2.state, t2.shed_reason) == (RequestState.SHED,
                                          ShedReason.QUEUE_FULL)
    assert "shed at admission" in t2.error
    assert t3.state == RequestState.PENDING  # 150 fits the budget exactly
    assert q.n_shed == 1 and q.pending_voxels() == 150


def test_deadline_shed_abstains_until_rate_known():
    pol = AdmissionPolicy(deadline_ms=50.0)
    q = RequestQueue(admission=pol)
    assert q.submit(FakeReq(100)).state == RequestState.PENDING
    pol.observe_service(1000, 1.0)  # 1,000 voxels/s: 100 ms of backlog
    t2 = q.submit(FakeReq(10))
    assert (t2.state, t2.shed_reason) == (RequestState.SHED,
                                          ShedReason.DEADLINE)
    # a ticket's own deadline overrides the policy's
    assert q.submit(FakeReq(10), deadline_ms=500.0).state == \
        RequestState.PENDING


def test_priority_displacement():
    q = RequestQueue(admission=AdmissionPolicy(max_pending_voxels=150))
    low = q.submit(FakeReq(100, "low"), priority=0)
    high = q.submit(FakeReq(100, "high"), priority=1)
    assert high.state == RequestState.PENDING
    assert (low.state, low.shed_reason) == (RequestState.SHED,
                                            ShedReason.DISPLACED)
    assert q.pending_tickets() == (high,) and q.pending_voxels() == 100
    peer = q.submit(FakeReq(100, "peer"), priority=1)  # no lower priority
    assert peer.shed_reason == ShedReason.QUEUE_FULL


def test_crashing_policy_sheds_instead_of_raising():
    class Broken:
        def admit(self, *a):
            raise KeyError("boom")

    q = RequestQueue(admission=Broken())
    t = q.submit(FakeReq(10))
    assert t.state == RequestState.SHED and "admission policy error" in \
        t.shed_reason
    assert q.n_shed == 1 and q.n_pending == 0
    with pytest.raises(ValueError, match="scheduled"):
        q.requeue(t)


# --------------------------------------------------------------------------
# the adaptive controller
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_controller_matches_jax_on_random_timings(seed):
    rng = np.random.default_rng(seed)
    kw = dict(min_depth=1, max_depth=int(rng.integers(1, 6)),
              depth=int(rng.integers(1, 5)),
              wave_voxels=int(rng.integers(100, 5000)),
              max_wave_voxels=8192,
              target_wave_ms=[None, 20.0][int(rng.integers(2))])
    p, j = padmission.AdaptiveController(**kw), \
        jadmission.AdaptiveController(**kw)
    assert (p.depth, p.wave_voxels) == (j.depth, j.wave_voxels)
    for _ in range(50):
        obs = dict(staging_s=float(rng.uniform(0, 0.02)),
                   compute_s=float(rng.uniform(0, 0.02)),
                   n_voxels=int(rng.integers(0, 20000)),
                   stalled=bool(rng.random() < 0.1))
        assert p.observe(**obs) == j.observe(**obs)


def test_controller_depth_rules():
    c = AdaptiveController(min_depth=1, max_depth=4, depth=2,
                           target_wave_ms=None)
    for _ in range(6):  # staging dominates compute: grow to max, stay
        d, cap = c.observe(staging_s=1.0, compute_s=1.0, n_voxels=128)
    assert (d, cap) == (4, None)
    for _ in range(12):  # staging hidden: shrink to min, stay
        d, _ = c.observe(staging_s=0.0, compute_s=1.0, n_voxels=128)
    assert d == 1


def test_controller_cap_sizing_and_stall():
    c = AdaptiveController(target_wave_ms=50.0, min_wave_voxels=128,
                           max_wave_voxels=4096)
    # 10k voxels/s -> 500 voxels in 50 ms -> snapped down to 384
    assert c.observe(staging_s=0.0, compute_s=0.1, n_voxels=1000)[1] == 384
    # a stall halves instead: 192 -> 128 on the lane grid
    assert c.observe(staging_s=0.0, compute_s=0.1, n_voxels=1000,
                     stalled=True)[1] == 128
    for _ in range(8):  # a huge rate is clamped to the bound
        _, cap = c.observe(staging_s=0.0, compute_s=0.001, n_voxels=10**6)
    assert cap == 4096


@pytest.mark.parametrize("kw, match", [
    (dict(min_depth=0), "min_depth"),
    (dict(min_depth=3, max_depth=2), "min_depth"),
    (dict(min_wave_voxels=512, max_wave_voxels=128), "wave_voxels"),
    (dict(min_wave_voxels=0), "wave_voxels"),
])
def test_controller_validates_bounds(kw, match):
    with pytest.raises(ValueError, match=match):
        AdaptiveController(**kw)


def test_ewma_shared_primitive():
    e = Ewma(alpha=0.5)
    assert e.update(10.0) == 10.0           # the first sample seeds it
    assert e.update(20.0) == 15.0
    assert e.update(15.0, alpha=0.0) == 15.0  # a per-call override

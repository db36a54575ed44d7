"""The port's training path: engine steps against ``repro.train.engine`` on
identical numpy params and batches, and the port's own contracts —
chunked == stepwise, crash + restart == uninterrupted, checkpoints, the
seekable batch stream, the refusals, and both launchers end to end.

Tolerances against JAX: params atol 1e-5 (fp32 sum order), QAT observers
rtol 1e-6, step counters exact.  Inside the port: bit for bit.  (The two
RNGs cannot agree, so chunked and ``batch_at`` runs are checked inside the
port only.)
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import qat as jqat
from repro.kernels.fused_train.ops import make_engine_step as jmake_engine_step
from repro.models import registry as jregistry
from repro.optim import optimizers as jopt
from repro.train import engine as jengine
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_smoke
from repro_torch.convert import (params_from_numpy, qstate_from_numpy,
                                 sgd_state_from_numpy, train_state_from_numpy)
from repro_torch.core import qat as pqat
from repro_torch.core.train_loop import TrainConfig, evaluate, train
from repro_torch.data.epg import default_sequence
from repro_torch.data.pipeline import (MRFSampleStream, batch_at, batch_seed,
                                       make_batch_factory)
from repro_torch.ft.checkpoint import (CheckpointManager, latest_step,
                                       restore_state, save_state)
from repro_torch.ft import runner
from repro_torch.ft.runner import RunnerConfig, run
from repro_torch.kernels.fused_train.ops import make_engine_step
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.mrf import build_mrf
from repro_torch.optim import optimizers as popt
from repro_torch.train import engine as pengine
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import leaves

CPU = "cpu"


def _np_params(sizes, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.uniform(-1, 1, (i, o)) * np.sqrt(6.0 / i)
                   ).astype(np.float32),
             "b": np.zeros((o,), np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])]


def _np_batches(n, batch, d_in, seed):
    rng = np.random.default_rng(seed)
    return [{"x": (0.2 * rng.normal(size=(batch, d_in))).astype(np.float32),
             "y": rng.uniform(0.02, 1.0, (batch, 2)).astype(np.float32)}
            for _ in range(n)]


def _bitequal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _close_params(got, want, atol=1e-5):
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=atol, rtol=0.0)


# --------------------------------------------------------------------------
# engine steps against the JAX engine
# --------------------------------------------------------------------------

ENGINE_CASES = {
    "float-adam": dict(backend="float", optimizer="adam", lr=1e-3),
    "float-sgd": dict(backend="float", optimizer="sgd", lr=2e-2),
    "float-adam-micro2-clip": dict(backend="float", optimizer="adam",
                                   lr=1e-3, microbatches=2,
                                   max_grad_norm=0.05),
    "qat-int8": dict(backend="qat-int8", optimizer="adam", lr=1e-3),
    "fused-sgd": dict(backend="fused", optimizer="sgd", lr=2e-2),
    "fused-adam": dict(backend="fused", optimizer="adam", lr=1e-3),
    "fused-sgd-tile16": dict(backend="fused", optimizer="sgd", lr=1e-2,
                             tile_batch=16),
    "float-adam-compress": dict(backend="float", optimizer="adam", lr=1e-3,
                                grad_compress=True),
    "qat-int8-compress": dict(backend="qat-int8", optimizer="adam", lr=1e-3,
                              grad_compress=True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_steps_match_jax(case):
    kw = dict(ENGINE_CASES[case])
    cfg = get_smoke("mrf-fpga")
    params = _np_params((32, 64, 64, 32, 16, 16, 16, 2), seed=1)
    batches = _np_batches(3, 64, 32, seed=2)
    n_layers = len(params)

    jkw = dict(kw, backend="fused-pallas" if kw["backend"] == "fused"
               else kw["backend"])
    if jkw["backend"] == "fused-pallas":
        jkw["interpret"] = True
    jstep, _ = jengine.build(jregistry.build(jget_smoke("mrf-fpga")),
                             jengine.EngineConfig(donate=False, **jkw))
    jo = getattr(jopt, kw["optimizer"])(kw["lr"])
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]
    qat = kw["backend"] == "qat-int8"
    compress = kw.get("grad_compress", False)
    jstate = jinit_train_state(jp, jo, grad_compress=compress,
                               aux=jqat.init_qat_state(n_layers)
                               if qat else None)

    pstep, _ = pengine.build(build_mrf(cfg), pengine.EngineConfig(**kw))
    pp = params_from_numpy(params, CPU)
    pstate = init_train_state(pp, getattr(popt, kw["optimizer"])(kw["lr"]),
                              grad_compress=compress,
                              aux=pqat.init_qat_state(n_layers, device=CPU)
                              if qat else None)
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = pstep(pstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    _close_params(pstate.params, jstate.params)
    assert int(pstate.step) == int(jstate.step) == 3
    assert int(pstate.opt_state.step) == int(jstate.opt_state.step)
    if kw["optimizer"] == "adam":
        _close_params(pstate.opt_state.mu, jstate.opt_state.mu, atol=1e-6)
        _close_params(pstate.opt_state.nu, jstate.opt_state.nu, atol=1e-7)
    if compress:  # the int8 error-feedback residuals
        _close_params(pstate.ef_residual, jstate.ef_residual, atol=1e-6)
    if qat:
        np.testing.assert_allclose(pstate.aux["act_absmax"].numpy(),
                                   np.asarray(jstate.aux["act_absmax"]),
                                   rtol=1e-6)


def test_refusals_match_jax():
    """Configs the fused path cannot honor fail at build time in both."""
    fused = lambda p, o, a, b: (p, o, a, {})  # noqa: E731
    for eng, fused_name, sgd, mts, mes in (
            (jengine, "fused-pallas", jopt.sgd, jmake_train_step,
             jmake_engine_step),
            (pengine, "fused", popt.sgd, make_train_step, make_engine_step)):
        with pytest.raises(ValueError, match="microbatches"):
            eng.EngineConfig(backend=fused_name, microbatches=2)
        with pytest.raises(ValueError, match="grad_compress"):
            eng.EngineConfig(backend=fused_name, grad_compress=True)
        with pytest.raises(ValueError, match="optimizer"):
            eng.EngineConfig(optimizer="rmsprop")
        with pytest.raises(ValueError, match="sgd"):
            mes(lr=1e-2, optimizer="rmsprop")
        with pytest.raises(ValueError, match="microbatches"):
            mts(None, sgd(1e-2), fused_step=fused, microbatches=4)
        with pytest.raises(ValueError, match="compress"):
            mts(None, sgd(1e-2), fused_step=fused, grad_compress=True)
    # the port's own: unknown backends; compression is the reference's
    # (optim.grad_compression) for every backend but the fused one
    with pytest.raises(ValueError, match="backend"):
        pengine.EngineConfig(backend="fused-pallas")
    for backend in ("float", "qat-int8"):
        assert pengine.EngineConfig(backend=backend,
                                    grad_compress=True).grad_compress
    state = init_train_state({"w": torch.ones(3)}, popt.sgd(1e-2),
                             grad_compress=True)
    assert torch.equal(state.ef_residual["w"], torch.zeros(3))
    step = make_train_step(lambda p, b: (p["w"] * b).sum(), popt.sgd(1e-2),
                           grad_compress=True)
    state, _ = step(state, torch.tensor([1.0, -2.0, 0.5]))
    assert state.ef_residual is not None


# --------------------------------------------------------------------------
# the port's own contracts: chunked, restart, checkpoints, the stream
# --------------------------------------------------------------------------

BACKENDS = ("float", "qat-int8", "fused", "fused-adam")


def _engine_cfg(backend, chunk_steps):
    if backend == "fused-adam":
        backend, optimizer = "fused", "adam"
    else:
        optimizer = "sgd" if backend == "fused" else "adam"
    return pengine.EngineConfig(backend=backend, lr=1e-3, optimizer=optimizer,
                                tile_batch=16, chunk_steps=chunk_steps)


def _train(backend, chunk_steps, ckpt_dir, *, total=10, ckpt_every=4,
           inject=None, batch=32):
    fns = build_mrf(get_smoke("mrf-fpga"))
    losses = []
    rcfg = RunnerConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                        ckpt_every=ckpt_every, inject_fault_at=inject)
    state, step, info = pengine.train(
        fns, _engine_cfg(backend, chunk_steps), rcfg,
        stream=pengine.default_stream(fns.cfg, batch), seed=1,
        on_metrics=lambda s, m, dt: losses.append((s, float(m["loss"]))),
        device=CPU)
    return state, step, losses, info


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunked_bitequals_stepwise(backend, tmp_path):
    """chunk_steps=4 over 10 steps runs chunks 4+4+2: the final state and
    every step's loss equal the stepwise run's, bit for bit."""
    s1, n1, l1, _ = _train(backend, 1, tmp_path / "stepwise")
    s4, n4, l4, _ = _train(backend, 4, tmp_path / "chunked")
    assert n1 == n4 == 10
    assert [s for s, _ in l4] == list(range(1, 11))
    assert l1 == l4
    _bitequal(s1, s4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_and_restart_bitequals_uninterrupted(backend, tmp_path):
    """A crash at step 6 (mid-chunk) clips the chunk there; the restart
    resumes from the step-4 checkpoint and ends where a run without the
    crash ends, chunked or stepwise."""
    s_plain, _, l_plain, _ = _train(backend, 4, tmp_path / "plain")
    s_crash, step, l_crash, _ = _train(backend, 4, tmp_path / "crash",
                                       inject=6)
    assert step == 10
    _bitequal(s_plain, s_crash)
    assert dict(l_crash) == dict(l_plain)  # steps 5..6 ran twice, alike
    s_step, _, _, _ = _train(backend, 1, tmp_path / "stepwise", inject=6)
    _bitequal(s_plain, s_step)


def test_chunks_clip_to_checkpoint_boundaries(tmp_path, monkeypatch):
    """The periodic checkpoints land on the period in both modes.  The
    straggler monitor is held quiet: on a loaded host a slow step makes it
    snapshot off the period (an eviction checkpoint at step 11)."""
    class Quiet(runner.StragglerMonitor):
        def update(self, step_seconds, host=0):
            return None

    monkeypatch.setattr(runner, "StragglerMonitor", Quiet)
    s1, _, l1, _ = _train("fused", 1, tmp_path / "a", total=12, ckpt_every=5)
    s4, _, l4, _ = _train("fused", 4, tmp_path / "b", total=12,
                          ckpt_every=5)  # chunks 4, 1, 4, 1, 2
    assert l1 == l4
    _bitequal(s1, s4)
    assert latest_step(tmp_path / "a") == latest_step(tmp_path / "b") == 10


def test_checkpoint_round_trip_and_keep(tmp_path):
    params = _np_params((32, 16, 2), seed=3)
    opt = popt.adam(1e-3)
    state = train_state_from_numpy(
        5, params, opt.init(params_from_numpy(params, CPU)),
        aux=np.array([1.5, 2.5], np.float32), device=CPU)
    wait = save_state(state, tmp_path, 5)
    wait()
    assert latest_step(tmp_path) == 5
    back = restore_state(state, tmp_path, device=CPU)
    assert type(back) is type(state)
    assert type(back.opt_state) is type(state.opt_state)
    assert back.ef_residual is None
    _bitequal(back, state)
    assert back.step.dtype == torch.int32

    mgr = CheckpointManager(tmp_path / "keep", keep=2, every=2)
    for step in range(1, 7):
        mgr.maybe_save(state, step)
    mgr.wait()
    assert sorted(p.name for p in (tmp_path / "keep").glob("step_*")) == [
        "step_4", "step_6"]
    assert mgr.restore_latest(state, device=CPU)[1] == 6
    with pytest.raises(ValueError, match="tensors"):
        restore_state({"only": state.step}, tmp_path, device=CPU)


def test_runner_requires_a_chunk_fn_and_retries_a_bounded_number(tmp_path):
    with pytest.raises(ValueError, match="chunk_fn"):
        run(None, None, lambda s: None,
            RunnerConfig(total_steps=4, ckpt_dir=str(tmp_path)),
            chunk_steps=4, device=CPU)
    state = train_state_from_numpy(0, _np_params((4, 2), 0),
                                   sgd_state_from_numpy(0, device=CPU),
                                   device=CPU)
    step_fn = lambda s, b: (s._replace(step=s.step + 1),  # noqa: E731
                            {"loss": torch.zeros(())})
    out, step = run(step_fn, state, lambda s: None,
                    RunnerConfig(total_steps=5, ckpt_dir=str(tmp_path / "r"),
                                 ckpt_every=2, inject_fault_at=3),
                    device=CPU)
    assert step == 5 and int(out.step) == 5


def test_batch_at_is_seekable_and_the_factory():
    stream = MRFSampleStream(seq=default_sequence(16), batch_size=16)
    a = batch_at(stream, 3, 7, device=CPU)
    _bitequal(a, batch_at(stream, 3, 7, device=CPU))
    _bitequal(a, make_batch_factory(stream, 3, device=CPU)(7))
    other = batch_at(stream, 3, 8, device=CPU)
    assert not torch.equal(a["x"], other["x"])
    assert a["x"].shape == (16, 32) and a["y"].shape == (16, 2)
    assert batch_seed(0, 0) == 2 ** 32 != batch_seed(0, 1) != batch_seed(1, 0)
    with pytest.raises(ValueError):
        batch_seed(0, -1)


def test_train_loop_and_evaluate(tmp_path):
    cfg = TrainConfig(n_frames=16, hidden=(32, 16), steps=4, batch_size=32,
                      lr=1e-3, log_every=2, qat=True)
    params, qstate, info = train(cfg, verbose=False, device=CPU)
    assert [i for i, _ in info["history"]] == [0, 2, 3]
    assert qstate["act_absmax"].shape == (3,)
    m = evaluate(params, default_sequence(16), qstate=qstate, n=200,
                 device=CPU)
    ints = pqat.export_int8(params, qstate)
    m8 = evaluate(params, default_sequence(16), int_layers=ints, n=200,
                  device=CPU)
    for out in (m, m8):
        assert all(np.isfinite(out[t][k]) for t in ("T1", "T2")
                   for k in out[t])
    # the same config through the fused backend (plain version here)
    cfg_f = TrainConfig(n_frames=16, hidden=(32, 16), steps=4, batch_size=32,
                        lr=1e-3, backend="fused", optimizer="sgd",
                        tile_batch=8, chunk_steps=2)
    params_f, _, _ = train(cfg_f, verbose=False, device=CPU)
    assert qstate_from_numpy(np.ones(3), CPU)["act_absmax"].dtype == \
        torch.float32
    assert params_f[0]["w"].shape == (32, 32)


# --------------------------------------------------------------------------
# the launchers end to end
# --------------------------------------------------------------------------

def _quiet(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("backend", ["float", "qat-int8", "fused"])
def test_train_launcher_all_backends(backend, tmp_path):
    rc, out = _quiet(train_launcher.main, [
        "--arch", "mrf-fpga", "--device", "cpu", "--smoke", "--steps", "3",
        "--batch", "128", "--ckpt-every", "2", "--backend", backend,
        "--lr", "1e-3", "--ckpt-dir", str(tmp_path / backend)])
    assert rc == 0
    assert (tmp_path / backend / "LATEST").exists()
    assert (tmp_path / backend / "step_2").exists()
    assert "train_report " in out.splitlines()[-1]


def test_train_launcher_fused_adam_chunked_with_a_crash(tmp_path):
    rc, out = _quiet(train_launcher.main, [
        "--arch", "mrf-fpga", "--device", "cpu", "--smoke", "--steps", "6",
        "--batch", "32", "--backend", "fused", "--optimizer", "adam",
        "--tile-batch", "16", "--chunk-steps", "4", "--ckpt-every", "4",
        "--inject-fault-at", "5", "--ckpt-dir", str(tmp_path)])
    assert rc == 0 and latest_step(tmp_path) == 4  # the last boundary
    assert '"steps": 6' in out.splitlines()[-1]
    # --grad-compress and --microbatches reach the engine (the fused
    # backend refuses both, as the reference's); LM archs train
    # (tests/test_torch_lm_train.py)
    rc, out = _quiet(train_launcher.main, [
        "--arch", "mrf-fpga", "--device", "cpu", "--smoke", "--steps", "2",
        "--batch", "32", "--grad-compress", "--microbatches", "2",
        "--ckpt-dir", str(tmp_path / "compress")])
    assert rc == 0 and '"steps": 2' in out.splitlines()[-1]
    with pytest.raises(ValueError, match="grad_compress"):
        train_launcher.main(["--arch", "mrf-fpga", "--device", "cpu",
                             "--smoke", "--backend", "fused",
                             "--grad-compress"])


@pytest.mark.parametrize("backend", ["int8", "float"])
def test_serve_launcher_trains_then_serves(backend):
    rc, out = _quiet(serve_launcher.main, [
        "--arch", "mrf-fpga", "--backend", backend, "--device", "cpu",
        "--smoke", "--phantom-n", "16", "--requests", "2"])
    assert rc == 0
    assert ("round-tripped" if backend == "int8" else "trained float") in out
    assert ("int8 engine == qat.int_forward oracle: bit-exact" in out
            if backend == "int8" else
            "float engine == mrf_net.forward oracle" in out)
    assert out.splitlines()[-1].startswith("serve_report ")


def test_training_entry_points_need_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    fns = build_mrf(get_smoke("mrf-fpga"))
    stream = MRFSampleStream(seq=default_sequence(16), batch_size=8)
    rcfg = RunnerConfig(total_steps=1, ckpt_dir=str(tmp_path))
    calls = [
        lambda: train_launcher.main(["--arch", "mrf-fpga", "--smoke",
                                     "--steps", "1"]),
        lambda: train(TrainConfig(n_frames=16, steps=1)),
        lambda: pengine.train(fns, pengine.EngineConfig(), rcfg),
        lambda: batch_at(stream, 0, 0),
        lambda: serve_launcher.main(["--arch", "mrf-fpga", "--smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

"""The port's examples (``examples/torch_*.py``) end to end at smoke size on
the CPU, where the kernels' plain versions run: what each prints is parsed
and held.

* ``torch_quickstart``: both int8 kernels' lines read bit-exact.
* ``torch_mrf_fpga_train``: each algorithm's Eq. 3 figures equal the port's
  cost model and are printed under the algorithm's name.
* ``torch_phantom_recon``: every slice ends ``done``; a poisoned slice
  makes the example exit 1.
* ``torch_serve_batch``: both SSM archs serve 8 x 48-token prompts and 24
  tokens, the launcher's ``token_report`` last, no B6 launch on the CPU.
* ``torch_lm_train_smoke``: the crash it injects is recovered from, and the
  run's losses and params equal an uninterrupted run's bit for bit.
* Without a card each example refuses the default ``--device cuda``.
"""

import contextlib
import functools
import importlib.util
import io
import json
import pathlib

import pytest
import torch

from repro_torch.core import fpga_cost_model as fcm
from repro_torch.core import mrf_net
from repro_torch.kernels.flash_attn.kernel import flash_attention_call
from repro_torch.kernels.fused_train import kernel as train_kernel
from repro_torch.kernels.fused_train import multistep
from repro_torch.serve.faults import FaultInjector

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
ADAPTED = mrf_net.layer_sizes(32)


@functools.cache
def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _example(name).main(argv)
    return rc, buf.getvalue().splitlines()


def _report(lines, tag):
    last = [ln for ln in lines if ln.startswith(tag + " ")]
    assert len(last) == 1 and lines[-1] == last[0]
    return json.loads(last[0].split(" ", 1)[1])


def test_quickstart_kernels_bit_exact_on_the_cpu():
    rc, lines = _run("torch_quickstart", ["--device", "cpu", "--steps", "3"])
    assert rc == 0
    exact = [ln.strip() for ln in lines if ln.strip().startswith(
        "qat.int_forward == ")]
    assert exact == ["qat.int_forward == B4 (fused kernel): True",
                     "qat.int_forward == B5 (layered kernel chain): True"]
    assert any(ln.strip().startswith("T1: MAPE") for ln in lines)


TRAIN_RUNS = {  # mode: (argv, tile, launches counted on a card)
    "stream, chunked": (["--mode", "stream", "--steps", "4", "--batch", "32",
                         "--chunk-steps", "2"], 1),
    "minibatch, stepwise": (["--mode", "minibatch", "--steps", "3",
                             "--batch", "256"], 128),
}


@pytest.mark.parametrize("run", list(TRAIN_RUNS))
def test_mrf_fpga_train_eq3_rows_match_the_cost_model(run):
    argv, tile = TRAIN_RUNS[run]
    counters = (train_kernel.fused_train_call,
                multistep.fused_train_multistep_call)
    before = [c.launches for c in counters]
    rc, lines = _run("torch_mrf_fpga_train", ["--device", "cpu", *argv])
    assert rc == 0
    assert [c.launches for c in counters] == before  # plain versions
    rep = _report(lines, "eq3_report")
    algorithm = fcm.train_algorithm(tile)
    h100 = fcm.h100_train_seconds(ADAPTED, 250_000_000, tile=tile,
                                  cluster=train_kernel.cluster_size(
                                      tile, ADAPTED))
    assert (rep["tile"], rep["algorithm"], rep["cluster"]) == \
        (tile, algorithm, h100["cluster"])
    assert rep["paper_fpga_s"] == fcm.paper_eq3_seconds() == 200.0
    assert rep["cycle_model_s"] == fcm.train_seconds(ADAPTED, 250_000_000)
    assert rep["h100_roofline_s"] == h100["t_total_s"]
    assert rep["paper_cpu_s"] == 16 * 3600.0
    batch = int(argv[argv.index("--batch") + 1])
    steps = int(argv[argv.index("--steps") + 1])
    assert rep["samples"] == steps * batch
    assert rep["s_per_250m"] == pytest.approx(
        rep["wall_s"] / rep["samples"] * 250_000_000)
    # the H100 roofline and this run's extrapolation name the algorithm
    for head in ("one H100's roofline", "this run on the host CPU"):
        row = [ln for ln in lines if ln.strip().startswith(head)]
        assert len(row) == 1 and algorithm in row[0]
    other = fcm.train_algorithm(128 if tile == 1 else 1)
    assert not any(other in ln for ln in lines)
    assert rep["last_loss"] < rep["first_loss"] or steps < 5


def test_phantom_recon_serves_every_slice():
    argv = ["--device", "cpu", "--train-steps", "5", "--slices", "3",
            "--phantom-n", "16"]
    rc, lines = _run("torch_phantom_recon", argv)
    assert rc == 0
    rep = _report(lines, "phantom_report")
    assert rep["states"] == ["done"] * 3 and rep["n_done"] == 3
    assert rep["voxels"] > 0 and rep["waves"] >= 1
    assert any("reconstructed T1 map" in ln for ln in lines)


def test_phantom_recon_exits_1_when_a_slice_fails(monkeypatch):
    mod = _example("torch_phantom_recon")
    poisoned = functools.partial(mod.ReconEngine, injector=FaultInjector(
        [{"kind": "assembly_corrupt", "request_id": "slice-1"}]))
    monkeypatch.setattr(mod, "ReconEngine", poisoned)
    rc, lines = _run("torch_phantom_recon", [
        "--device", "cpu", "--train-steps", "5", "--slices", "3",
        "--phantom-n", "16"])
    assert rc == 1
    rep = _report(lines, "phantom_report")
    assert rep["states"] == ["done", "failed", "done"]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_serve_batch_serves_both_ssm_families(arch):
    before = flash_attention_call.launches
    rc, lines = _run("torch_serve_batch", ["--arch", arch, "--smoke",
                                           "--device", "cpu"])
    assert rc == 0
    rep = _report(lines, "token_report")
    assert (rep["arch"], rep["requests"], rep["prompt"], rep["gen"]) == \
        (f"{arch}-smoke", 8, 48, 24)
    assert len(rep["tokens"]) == 8 and {len(t) for t in rep["tokens"]} == {24}
    assert rep["flash_attn_launches"] == 0
    assert flash_attention_call.launches == before


def test_lm_train_smoke_recovers_from_its_crash(tmp_path):
    """The LM training example (smoke tinyllama, 4 steps, checkpoints every
    2, the crash at step 2): the runner restarts, and the report's losses
    and params digest equal an uninterrupted run's through the launcher."""
    from repro_torch.launch import train as train_launcher

    rc, lines = _run("torch_lm_train_smoke", [
        "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "32",
        "--ckpt-every", "2"])
    assert rc == 0 and "crash injected at step 2" in lines[0]
    got = _report(lines, "train_report")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_launcher.main([
            "--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "32", "--ckpt-dir",
            str(tmp_path)])
    want = _report(buf.getvalue().splitlines(), "train_report")
    assert got["train_step_calls"] == 4  # the crash came before step 2 ran
    assert got["losses"] == want["losses"] and \
        got["params_digest"] == want["params_digest"]


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_mrf_fpga_train",
                                  "torch_phantom_recon", "torch_serve_batch",
                                  "torch_lm_train_smoke"])
def test_examples_refuse_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(name, [])

"""Multi-rank runs of the port's sharded path on the CPU: gloo process
groups of 2 and 4 spawned ranks (``tests/_torch_dist_worker.py``, each a
process of its own joined through a ``file://`` store under ``tmp_path``,
with its own join timeout), held against the single-process port.

* The smoke tinyllama on ``(data 2, model 2)`` and ``(data 1, model 2)``
  (heads split over ``model``, params and moments sharded over ``data``
  by ``fsdp``, B6 on each rank's local heads): the loss, every gradient,
  one Adam step's params, prefill and two decode steps, and the loss and
  gradients again under sequence parallelism.  A rerun of the step
  repeats its bits.  The cross entropy alone over a split vocab.
* A checkpoint saved on the 4 ranks restores on 2 ranks and on one
  process bit for bit, then reshards onto other rules.
* ``mrf-fpga`` on ``(data 2)`` through ``launch.train --mesh single``:
  ``fused`` runs the kernel on the whole batch on every rank (bit for bit
  the mesh-less run), ``float`` and ``qat-int8`` data-parallel; the
  executor's B4, B5 and float maps under the mesh.

Tolerances (bf16 activations; the ranks sum tensor-parallel partial
products and data-parallel gradients in other orders than one process):
* the loss: rtol ``LOSS_RTOL`` = 1e-4 (seen: 3e-5);
* every gradient leaf: within ``GRAD_ULPS`` = 8 bf16 ulps of the leaf's
  largest magnitude, as against the reference (``test_torch_lm_train.py``;
  seen: up to 2).  It breaks when one data rank's contribution is dropped
  (:func:`test_gradient_tolerance_breaks_on_a_dropped_rank`);
* one Adam step's params: within ``2 lr`` (a gradient near 0 whose sign
  differs moves an element by ``2 lr``, the reference tolerance of
  ``test_torch_lm_train.py``), and within 1e-6 for 95% of each leaf's
  elements (seen: 98.6%);
* the cross entropy alone, f32 logits whose vocab the mesh splits:
  ``CE_RTOL`` = 1e-6 for the loss and the logits' gradient;
* logits (prefill, two decode steps): ``LOGIT_ULPS`` = 4 bf16 ulps of the
  largest (one ulp a layer of the partial sums' rounding, twice the
  reference tolerance's 2).
* MRF ``fused`` and the int8 maps: bit for bit; ``float`` / ``qat-int8``
  losses at rtol 1e-5 of the mesh-less run (a two-way gradient sum).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from repro_torch.configs import get_smoke
from repro_torch.core import qat
from repro_torch.core import mrf_net
from repro_torch.data.pipeline import denormalize_targets
from repro_torch.models import registry
from repro_torch.models.lm import cross_entropy
from repro_torch.optim import adam
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import leaves, rebuild

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_dist_worker.py"
JOIN_TIMEOUT = 150  # seconds a rank may take
LOSS_RTOL, GRAD_ULPS, LOGIT_ULPS, LR = 1e-4, 8, 4, 3e-4
CE_RTOL = 1e-6



def _spawn(job, data, model, tmp, *extra):
    """``data * model`` ranks of ``job``; rank 0's results."""
    world = data * model
    out = tmp / f"{job}-{data}x{model}"
    out.mkdir(parents=True, exist_ok=True)
    init = tmp / f"store-{job}-{data}x{model}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), job, str(r), str(world), str(init),
         str(out), str(data), str(model), *map(str, extra)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, (bad, [log[-3000:] for log in logs])
    return torch.load(out / f"{job}_result.pt", weights_only=False), out


def _bf16_ulp(t) -> float:
    m = float(t.abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _grads_within(got, want) -> bool:
    return all(float((g - w).abs().max()) <= GRAD_ULPS * _bf16_ulp(w)
               for g, w in zip(got, want))


def _single_process(data_rows=None):
    """The port on one process (no mesh) at tp 2: the loss, the gradients,
    one Adam step's params, prefill and two decode steps' logits.
    ``data_rows``: the gradient of the loss over those rows only, halved —
    what the data-parallel mean gives when the other data rank's
    contribution is dropped."""
    cfg = get_smoke("tinyllama-1.1b")
    fns = registry.build(cfg, 2)
    params = fns.init(0, device="cpu")
    batch = worker.lm_batch(cfg)
    if data_rows is not None:
        batch = {k: v[data_rows] for k, v in batch.items()}
    live = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss = fns.loss(rebuild(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    if data_rows is not None:
        return [g / 2 for g in grads]
    new, _ = make_train_step(fns.loss, adam(LR), max_grad_norm=1.0)(
        init_train_state(params, adam(LR)), batch)
    with torch.no_grad():
        cache, logits = fns.prefill(params, {"tokens": batch["tokens"]})
        out = [logits]
        for i, tok in enumerate(worker.decode_tokens(cfg)):
            logits, cache = fns.decode(params, cache, tok, 32 + i)
            out.append(logits)
    return {"loss": loss.detach(), "grads": grads,
            "new_params": leaves(new.params), "logits": out}


@pytest.fixture(scope="module")
def single():
    return _single_process()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both LM meshes, the 4-rank checkpoint restored on 2 ranks, MRF."""
    tmp = tmp_path_factory.mktemp("dist")
    lm22, out22 = _spawn("lm", 2, 2, tmp)
    lm12, _ = _spawn("lm", 1, 2, tmp)
    restore, _ = _spawn("restore", 1, 2, tmp, out22)
    mrf, _ = _spawn("mrf", 2, 1, tmp)
    return {"2x2": lm22, "1x2": lm12, "restore": restore, "mrf": mrf,
            "ckpt": out22}


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_lm_step_matches_one_process(runs, single, mesh):
    got = runs[mesh]
    np.testing.assert_allclose(float(got["loss"]), float(single["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["step_loss"]), float(got["loss"]),
                               rtol=0, atol=0)
    assert got["grad_placements_match"] and got["state_all_dtensor"]
    assert _grads_within(got["grads"], single["grads"])
    for p, w in zip(got["new_params"], single["new_params"]):
        gap = (p - w).abs()
        assert float(gap.max()) <= 2 * LR * (1 + 1e-3)
        assert float((gap <= 1e-6).float().mean()) >= 0.95
    assert got["rerun_bit_equal"]


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_sequence_parallel_matches_one_process(runs, single, mesh):
    """``rules_for(sequence_parallel=True)``: the residual stream between
    blocks (and the embeddings) is split over the sequence on ``model``
    (``Shard(1)``, the batch on ``data``), attention gathers the sequence
    before B6; the loss and every gradient match one process within the
    mesh's tolerances (the port's counterpart of the reference's
    ``test_sequence_parallel_lowers_act_seq_to_model``)."""
    got = runs[mesh]
    assert got["sp_rule"] == "model"
    n_layers = get_smoke("tinyllama-1.1b").n_layers
    # the embeddings; each block's residual after its attention (again in
    # the block's recompute) and its output
    assert got["sp_residual"] == ["(Shard(dim=0), Shard(dim=1))"] * (
        3 * n_layers + 1)
    np.testing.assert_allclose(float(got["sp_loss"]), float(single["loss"]),
                               rtol=LOSS_RTOL)
    assert _grads_within(got["sp_grads"], single["grads"])


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_lm_prefill_and_decode_match_one_process(runs, single, mesh):
    for got, want in zip(runs[mesh]["logits"], single["logits"]):
        w = want.float()
        assert float((got.float() - w).abs().max()) <= \
            LOGIT_ULPS * _bf16_ulp(w)


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_split_vocab_cross_entropy_matches_one_process(runs, mesh):
    """The cross entropy over a vocab split across ``model`` (padded
    columns on the last rank, masked labels) against one process: f32 sums
    of 64 columns in two parts."""
    logits, labels = worker.ce_inputs()
    live = logits.clone().requires_grad_(True)
    want = cross_entropy(live, labels, worker.CE_VOCAB)
    loss, grad = runs[mesh]["ce"]
    np.testing.assert_allclose(float(loss), float(want.detach()),
                               rtol=CE_RTOL)
    np.testing.assert_allclose(grad.numpy(), torch.autograd.grad(
        want, live)[0].numpy(), rtol=CE_RTOL, atol=1e-9)


def test_shard_refuses_a_plain_tensor_under_a_mesh(runs):
    """Under a mesh of more than one device a plain tensor never passes
    ``shard`` silently; fully replicated axes stay the identity."""
    for mesh in ("2x2", "1x2"):
        assert runs[mesh]["plain_refused"]
        assert runs[mesh]["replicated_is_identity"]


def test_gradient_tolerance_breaks_on_a_dropped_rank(runs, single):
    """The gradients of the data-parallel mean with data rank 1's
    contribution dropped (rank 0's rows only, halved) fail the tolerance
    the mesh's gradients pass."""
    dropped = _single_process(data_rows=slice(0, 2))
    assert _grads_within(runs["2x2"]["grads"], single["grads"])
    assert not _grads_within(dropped, single["grads"])


def test_checkpoint_of_4_ranks_restores_on_2_and_reshards(runs):
    got = runs["restore"]
    assert got["restored_bit_equal"] and got["restored_all_dtensor"]
    assert got["resharded_bit_equal"] and got["resharded_placements"]
    mesh, rules = got["survivor"]
    assert mesh == {"data": 1, "model": 2}
    assert rules["batch"] == rules["fsdp"] == "data" and rules["tp"] == "model"


def test_checkpoint_of_4_ranks_restores_on_one_process(runs):
    """No process group, no placements: every leaf whole, bit for bit."""
    from repro_torch.ft.checkpoint import restore_state
    want = torch.load(runs["ckpt"] / "ckpt_expected.pt", weights_only=False)
    got = restore_state(want, runs["ckpt"] / "ckpt", device="cpu")
    assert all(torch.equal(a, b) and type(a) is torch.Tensor
               for a, b in zip(leaves(got), leaves(want)))


def test_mrf_under_the_mesh(runs):
    got = runs["mrf"]
    for backend in ("float", "fused", "qat-int8"):
        rep = got[backend]
        assert rep["mesh"] == {"data": 2, "model": 1}
        assert rep["dtensor_leaves"] == rep["state_leaves"]
    x = got["x"]
    oracle = denormalize_targets(qat.int_forward(got["ints"], x)).numpy()
    for impl in ("fused", "layered"):
        np.testing.assert_array_equal(got[f"maps_{impl}"], oracle)
    np.testing.assert_allclose(
        got["float_maps"],
        denormalize_targets(mrf_net.forward(got["params"], x)).numpy(),
        rtol=1e-6)


@pytest.mark.parametrize("backend", ["float", "fused", "qat-int8"])
def test_mrf_mesh_matches_the_meshless_run(runs, backend, capsys):
    from repro_torch.launch import train
    train.main(["--arch", "mrf-fpga", "--smoke", "--device", "cpu",
                "--backend", backend, "--steps", "3", "--batch", "128",
                "--ckpt-every", "0"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("train_report ")][-1]
    want = json.loads(line[len("train_report "):])
    got = runs["mrf"][backend]
    if backend == "fused":  # the kernel on the whole batch, every rank
        assert got["params_digest"] == want["params_digest"]
        assert got["last_loss"] == want["last_loss"]
    else:
        np.testing.assert_allclose(got["last_loss"], want["last_loss"],
                                   rtol=1e-5)

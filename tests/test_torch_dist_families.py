"""Multi-rank runs of the MoE, SSM, hybrid, encoder-decoder and VLM
families on the CPU: gloo process groups of spawned ranks
(``tests/_torch_dist_worker.py``, each a process of its own joined through
a ``file://`` store under ``tmp_path``), spawned once per mesh — ``(data 2,
model 2)``, ``(data 1, model 2)`` and one rank's ``(1, 1)`` — with all five
families run in them, held against the single-process port (itself held
against the JAX package by ``test_torch_lm_train_families.py``).

The smoke configs of deepseek-moe-16b (4 experts, top-2, 1 shared),
mamba2-1.3b, hymba-1.5b (at 3 layers: a window layer between two global
ones), seamless-m4t-large-v2 and llava-next-34b, each on one process and on
the mesh: the loss, every gradient leaf, one Adam step's params, prefill
and two decode steps' logits.  The experts run expert-parallel over
``model``, the SSM heads over ``model``, attention (B6's plain version
here) per rank in ``local_map``.

MoE routing: a (token, choice) whose expert differs between one process
and the ranks (a near-tie in the router meets an activation an ulp apart:
the ranks sum tensor-parallel partial products in another order) is
counted; the ranks then run on the one-process choices, with their own
probabilities at them as gates (``worker.RoutingReplay``, as
``chip_smoke.RoutingReplay`` does for card vs CPU), so both sides compute
one function.  More than ``MOE_FLIP_SHARE`` = 5% of a layer's pairs
flipped fails.

Tolerances, those of ``test_torch_dist_ranks.py`` unchanged:
* the loss: rtol ``LOSS_RTOL`` = 1e-4;
* every gradient leaf: within ``GRAD_ULPS`` = 8 bf16 ulps of the leaf's
  largest magnitude;
* one Adam step's params: within ``2 lr`` (a gradient near 0 whose sign
  differs moves an element by ``2 lr``), and within 1e-6 for 95% of each
  leaf's elements — of those whose one-process gradient is at least
  ``ADAM_WELL`` = 1e-6 (100 times Adam's eps) in magnitude and has the
  sign of the ranks' gradient.  Below ``ADAM_WELL``, Adam's first step
  ``lr * g / (|g| + 1e-8)`` turns a gradient difference well inside
  ``GRAD_ULPS`` into a step difference of up to ``lr``: the SSM mixer's
  ``wB``, ``wC``, ``wdt``, ``dt_bias``, ``A_log`` and conv taps have
  gradients of 5e-8 to 3e-6 at this size, and 22-60% of their elements (a
  few percent of hymba's attention projections') move by more than 1e-6
  although every gradient leaf is within 8 ulps.  A gradient whose sign
  differs, which the gradient tolerance allows near 0, moves its element
  by 2 lr (one of mamba2's 8 ``D`` gradients, -6.2e-6 on one process and
  4.4e-5 on the ranks, in a leaf whose tolerance is 2.4e-4).  The
  tinyllama of ``test_torch_dist_ranks.py`` has no such leaf;
* logits (prefill, two decode steps): ``LOGIT_ULPS`` = 4 bf16 ulps of the
  largest.
The MoE block alone on the same bf16 input on both sides: its output
within ``LOGIT_ULPS``, its gradients within ``GRAD_ULPS``, and the balance
term within ``BALANCE_RTOL`` = 1e-6 (f32 means of the groups, summed over
the data ranks in another order).  Bit for bit: ``int8_roundtrip`` of the
mesh's gradients against that of the whole gradients (the scale is the
whole leaf's), the checkpoints restored, and every family through
``launch.train --mesh single`` on one rank against the mesh-less run.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_dist_worker.py"
JOIN_TIMEOUT = 600  # seconds a rank may take (the suite shares the cores)
LOSS_RTOL, GRAD_ULPS, LOGIT_ULPS, LR = 1e-4, 8, 4, 3e-4
BALANCE_RTOL = 1e-6
#: Adam's first step, lr * g / (|g| + 1e-8), is well conditioned where |g|
#: is at least 100 of its eps: elsewhere a gradient well inside GRAD_ULPS
#: moves the step by up to lr (module docstring)
ADAM_WELL = 1e-6
MOE_FLIP_SHARE = 0.05
ARCHS = worker.FAMILY_ARCHS
MESHES = ("2x2", "1x2")
CKPT_ARCHS = ("deepseek-moe-16b", "seamless-m4t-large-v2")


def _start(job, data, model, tmp, *extra):
    """``data * model`` ranks of ``job``, started; (processes, out dir)."""
    world = data * model
    out = tmp / f"{job}-{data}x{model}"
    out.mkdir(parents=True, exist_ok=True)
    init = tmp / f"store-{job}-{data}x{model}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(WORKER), job, str(r), str(world), str(init),
         str(out), str(data), str(model), *map(str, extra)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)], out


def _wait(started, job):
    """Rank 0's results of ``started`` (:func:`_start`), every rank
    joined."""
    procs, out = started
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn a mesh: the (2, 2) ranks (which save the checkpoints)
    beside the one-rank (1, 1) launcher runs, then the (1, 2) ranks (which
    restore them)."""
    tmp = tmp_path_factory.mktemp("dist_families")
    one = _start("world1", 1, 1, tmp)
    four = _start("families", 2, 2, tmp)
    world1, _ = _wait(one, "world1")
    r22, out22 = _wait(four, "families")
    r12, _ = _wait(_start("families", 1, 2, tmp, out22), "families")
    return {"world1": world1, "2x2": r22, "1x2": r12, "ckpt": out22}


def _bf16_ulp(t) -> float:
    m = float(t.float().abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _within_ulps(got, want, ulps) -> list:
    """The leaves (by index) further than ``ulps`` bf16 ulps of the want
    leaf's largest magnitude."""
    return [i for i, (g, w) in enumerate(zip(got, want))
            if not float((g.float() - w.float()).abs().max())
            <= ulps * _bf16_ulp(w)]


def _adam_step_within(got, want, grads, mesh_grads) -> list:
    """The leaves (by index) of one Adam step's params further than ``2
    lr`` anywhere, or than 1e-6 at more than 5% of the elements whose
    one-process gradient ``grads`` is at least ``ADAM_WELL`` in magnitude
    and has the sign of the ranks' gradient ``mesh_grads``."""
    bad = []
    for i, (p, w, g, h) in enumerate(zip(got, want, grads, mesh_grads)):
        gap = (p - w).abs()
        kept = gap[(g.abs() >= ADAM_WELL)
                   & (torch.sign(g) == torch.sign(h.to(g.dtype)))]
        if not (float(gap.max()) <= 2 * LR * (1 + 1e-3) and (
                kept.numel() == 0
                or float((kept <= 1e-6).float().mean()) >= 0.95)):
            bad.append(i)
    return bad


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_family_step_matches_one_process(runs, mesh, arch):
    """The loss, every gradient leaf (placed as its parameter) and one Adam
    step's params; every state leaf a DTensor."""
    ref, got = runs[mesh][arch]["ref"], runs[mesh][arch]["mesh"]
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=LOSS_RTOL)
    assert got["grad_placements_match"] and got["state_all_dtensor"]
    assert len(got["grads"]) == len(ref["grads"])
    assert _within_ulps(got["grads"], ref["grads"], GRAD_ULPS) == []
    assert _adam_step_within(got["new_params"], ref["new_params"],
                             ref["grads"], got["grads"]) == []


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_family_prefill_and_decode_match_one_process(runs, mesh, arch):
    """Prefill and two decode steps (a hybrid's window ring wraps, the
    encoder-decoder's cross cache is read, the MoE's decode group spans
    the batch); the cache the prefill made and decode wrote is placed as
    ``registry.cache_axes`` (``input_specs.decode_axes``) says."""
    ref, got = runs[mesh][arch]["ref"], runs[mesh][arch]["mesh"]
    assert len(got["logits"]) == 3
    for g, w in zip(got["logits"], ref["logits"]):
        assert float((g.float() - w.float()).abs().max()) <= \
            LOGIT_ULPS * _bf16_ulp(w)
    assert got["cache_placed_by_axes"]


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_routing_flips_within_share(runs, mesh):
    """Every rank's routing against the one-process record, by phase and
    layer: at most ``MOE_FLIP_SHARE`` of the (token, choice) pairs flip."""
    per_rank = runs[mesh]["deepseek-moe-16b"]["mesh"]["routing"]
    assert len(per_rank) == (4 if mesh == "2x2" else 2)
    for flips, pairs in per_rank:
        assert set(flips) >= {("train", 0), ("train", 1), ("prefill", 0),
                              ("decode0", 1)}
        for key, n in flips.items():
            assert n <= MOE_FLIP_SHARE * pairs[key], (key, n, pairs[key])


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_experts_stay_split_over_model(runs, mesh):
    """No rank holds more than E / model experts' weights, gradients or
    Adam moments, before or after the step."""
    assert runs[mesh]["deepseek-moe-16b"]["mesh"]["experts_split"]


def _block_matches(case):
    ref, got = case["ref"], case["mesh"]
    assert float((got["y"].float() - ref["y"].float()).abs().max()) <= \
        LOGIT_ULPS * _bf16_ulp(ref["y"])
    assert _within_ulps(got["grads"], ref["grads"], GRAD_ULPS) == []
    return ref, got


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_balance_term_reduced_over_the_batch(runs, mesh):
    """The MoE block on two groups (one a data rank at (2, 2)): the balance
    term's two means are reduced over the data ranks before their product,
    so it equals one process's (a mean of per-rank terms would not); the
    whole model's balance term too, within the loss's tolerance."""
    case = runs[mesh]["deepseek-moe-16b"]["mesh"]["block"]["train"]
    assert case["flips"] == 0
    ref, got = _block_matches(case)
    np.testing.assert_allclose(float(got["aux"]), float(ref["aux"]),
                               rtol=BALANCE_RTOL)
    fam = runs[mesh]["deepseek-moe-16b"]
    np.testing.assert_allclose(float(fam["mesh"]["balance"]),
                               float(fam["ref"]["balance"]), rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_block_with_fewer_rows_than_batch_ranks(runs, mesh):
    """One row of 512 tokens, two routing groups: at (2, 2) the two data
    ranks cannot each hold a whole row, so every rank routes both groups
    (no rank routes none, whose balance means would be NaN); y, the
    gradients and the balance term equal one process's."""
    case = runs[mesh]["deepseek-moe-16b"]["mesh"]["block"]["one_row"]
    assert case["flips"] == 0
    ref, got = _block_matches(case)
    assert bool(torch.isfinite(got["aux"]))
    np.testing.assert_allclose(float(got["aux"]), float(ref["aux"]),
                               rtol=BALANCE_RTOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_decode_group_spans_the_batch(runs, mesh):
    """16 decode tokens, one routing group over the data ranks, at
    capacity factor 0.5 (4 slots an expert for 32 choices): which choices
    are dropped depends on the slots the whole group's earlier tokens took,
    whichever rank holds them."""
    case = runs[mesh]["deepseek-moe-16b"]["mesh"]["block"]["decode"]
    assert case["flips"] == 0
    _block_matches(case)
    np.testing.assert_allclose(float(case["mesh"]["aux"]),
                               float(case["ref"]["aux"]), rtol=BALANCE_RTOL)


def test_grad_compress_step_on_the_mesh(runs):
    """``--grad-compress`` on (2, 2): one compressed Adam step equals one
    process's; the error-feedback residuals are DTensors placed as the
    params; the int8 round trip of the mesh's gradients equals that of the
    whole gradients bit for bit (each leaf's scale is the whole leaf's
    ``max|g| / 127 + 1e-12``, not a shard's)."""
    got = runs["2x2"]["deepseek-moe-16b"]["mesh"]["compress"]
    assert got["residual_placed_as_params"]
    assert got["roundtrip_bit_equal"]
    fam = runs["2x2"]["deepseek-moe-16b"]
    assert _adam_step_within(got["new_params"], got["ref_params"],
                             fam["ref"]["grads"], fam["mesh"]["grads"]) == []


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_family_checkpoint_of_4_ranks_restores_on_2_and_reshards(runs, arch):
    """The stepped state saved on the (2, 2) ranks (deepseek's with its
    ``ef_residual``) restores on the (1, 2) ranks bit for bit, all
    DTensors, then reshards onto rules with ``fsdp`` replicated: the values
    kept, the placements the new rules'."""
    got = runs["1x2"][arch]["mesh"]["restore"]
    assert got == {"bit_equal": True, "all_dtensor": True,
                   "resharded_bit_equal": True,
                   "resharded_placements": True}


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_family_checkpoint_of_4_ranks_restores_on_one_process(runs, arch):
    from repro_torch.ft.checkpoint import restore_state
    from repro_torch.tree import leaves
    want = torch.load(runs["ckpt"] / f"ckpt-{arch}.pt", weights_only=False)
    got = restore_state(want, runs["ckpt"] / f"ckpt-{arch}", device="cpu")
    assert (want.ef_residual is not None) == (arch == "deepseek-moe-16b")
    assert all(torch.equal(a, b) and type(a) is torch.Tensor
               for a, b in zip(leaves(got), leaves(want)))


def _mesh_less(runs, arch, extra=()):
    return next(none for a, e, none, _ in runs["world1"]
                if a == arch and tuple(e) == tuple(extra))


@pytest.mark.parametrize("arch", [*ARCHS, "compress"])
def test_launcher_trains_every_family_on_the_mesh(runs, arch):
    """``launch.train --mesh single`` on the (1, 2) ranks (``LOCAL_WORLD_SIZE``
    2: the ``model`` dim), deepseek also with ``--grad-compress``: each
    step's loss within ``LOSS_RTOL`` of the mesh-less launcher's, every
    state leaf a DTensor on the mesh."""
    got = runs["1x2"]["launcher"][arch]
    want = _mesh_less(runs, "deepseek-moe-16b", ["--grad-compress"]) \
        if arch == "compress" else _mesh_less(runs, arch)
    assert got["mesh"] == {"data": 1, "model": 2}
    assert got["dtensor_leaves"] == got["state_leaves"] > 0
    assert got["losses"].keys() == want["losses"].keys()
    for k in want["losses"]:
        np.testing.assert_allclose(got["losses"][k], want["losses"][k],
                                   rtol=LOSS_RTOL)


def test_launcher_mesh_multi_with_grad_compress(runs):
    """``--mesh multi`` on 4 ranks (pod 2, data 1, model 2), mamba2 with
    ``--grad-compress``: the batch over pod and data, the heads over
    model."""
    got = runs["2x2"]["launcher_multi"]
    want = _mesh_less(runs, "mamba2-1.3b")
    assert got["mesh"] == {"pod": 2, "data": 1, "model": 2}
    assert got["dtensor_leaves"] == got["state_leaves"] > 0
    np.testing.assert_allclose(got["first_loss"], want["first_loss"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("i", range(len(ARCHS) + 1))
def test_mesh_single_on_one_rank_is_bit_equal(runs, i):
    """World 1, the (1, 1) mesh: every redistribution is local and each
    per-rank block runs the mesh-less ops on whole tensors, so ``--mesh
    single`` repeats the mesh-less run's losses and params bit for bit
    (every family; deepseek also with ``--grad-compress``)."""
    arch, extra, plain, meshed = runs["world1"][i]
    assert meshed["mesh"] == {"data": 1, "model": 1}
    assert meshed["dtensor_leaves"] == meshed["state_leaves"] > 0
    assert meshed["losses"] == plain["losses"], (arch, extra)
    assert meshed["params_digest"] == plain["params_digest"], (arch, extra)

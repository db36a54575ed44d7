"""The LM training job (``launch.train.lm_job``) that the launcher's LM
branch and the benchmark's LM harness both run: the launcher's reports on
``--smoke`` are those the launcher printed before its LM branch was split
into the job (``fixtures/lm_train_smoke_reports.json``, recorded from the
commit named there with the argv named there: the keys in order, the
losses, the train-step calls and the params' digest), and the job trains
a tied head as one leaf, updated by the sum of its two uses' gradients."""

import contextlib
import dataclasses
import io
import json
import pathlib

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.data.lm_text import TextPipeline
from repro_torch.launch import train as launcher
from repro_torch.models import registry
from repro_torch.optim.optimizers import global_norm
from repro_torch.tree import leaves, rebuild

FIXTURE = json.loads((pathlib.Path(__file__).parent / "fixtures"
                      / "lm_train_smoke_reports.json").read_text())


def _report(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert launcher.main(argv) == 0
    last = buf.getvalue().splitlines()[-1]
    return json.loads(last[len("train_report "):])


@pytest.mark.parametrize("arch", sorted(FIXTURE["reports"]))
def test_the_job_split_leaves_the_smoke_reports_unchanged(arch):
    want = FIXTURE["reports"][arch]
    got = _report(["--arch", arch] + FIXTURE["argv"])
    assert list(got) == want["keys"]
    assert got["losses"] == want["losses"]
    assert got["loss_log"] == want["loss_log"]
    assert got["train_step_calls"] == want["train_step_calls"]
    assert got["params_digest"] == want["params_digest"]


def test_the_job_trains_a_tied_head_as_one_leaf(tmp_path):
    """mamba2's smoke model tied: the job's state has the embedding and no
    head, and Adam's first step moves each embedding entry by ``-lr g /
    (|g| + eps)`` of the clipped gradient that sums the lookup's and the
    head's uses (a model whose head is the embedding's transpose)."""
    cfg = dataclasses.replace(get_smoke("mamba2-1.3b"), tie_embeddings=True)
    cpu, lr, b, s = torch.device("cpu"), 3e-4, 2, 32
    seen = []
    run = launcher.lm_job(cfg, batch=b, seq=s, steps=1, lr=lr,
                          ckpt_dir=str(tmp_path), ckpt_every=0, device=cpu,
                          seed=7, data_seed=11,
                          on_step=lambda *a: seen.append(a))
    assert isinstance(run, launcher.LmRun) and run.step == 1
    assert [a[0] for a in seen] == [1]
    assert "head" not in run.state.params
    p0 = registry.build(cfg).init(7, device=cpu)
    untied = registry.build(dataclasses.replace(cfg, tie_embeddings=False))
    pipe = TextPipeline(seq_len=s, batch_size=b, vocab_size=256, seed=11)
    batch = launcher.lm_batches(cfg, pipe, cpu)(0)
    live = [t.detach().requires_grad_(True) for t in
            leaves({**p0, "head": p0["embed"].t()})]
    tree = rebuild({**p0, "head": p0["embed"].t()}, live)
    loss = untied.loss(tree, batch)
    grads = rebuild(tree, torch.autograd.grad(loss, live))
    assert run.losses[1] == pytest.approx(float(loss.detach()), rel=1e-6)
    g = grads["embed"] + grads["head"].t()  # the two uses
    others = {k: v for k, v in grads.items() if k not in ("embed", "head")}
    norm = float(global_norm({**others, "embed": g}))
    assert run.grad_norms[1] == pytest.approx(norm, rel=1e-4)
    g = g * min(1.0, 1.0 / norm)
    want = -lr * g / (g.abs() + 1e-8)
    moved = run.state.params["embed"] - p0["embed"]
    torch.testing.assert_close(moved, want, rtol=1e-3, atol=lr * 1e-3)
    # where the head's use and the lookup's pull apart, the sum decides
    split = (grads["embed"] * grads["head"].t() < 0) & (g.abs() > 1e-6)
    assert split.any()

"""mamba2-1.3b's port against the plain PyTorch reference
(``tests/plain/mamba2.py``) on the CPU at the smoke size, on seeded random
weights scaled so that every part of the mixer moves the output: the
matrix form of the scan against the sequential recurrence; the logits, the
loss and every gradient leaf at lengths that are a multiple of the chunk
(8) and lengths that are not, with the head untied and tied; a scan that
drops the inter-chunk term or the D skip fails the same bounds; the tied
head is one leaf whose gradient is the sum of its two uses.

The bounds: the port's activations are bf16 (8 bits of mantissa, each
op rounded), the reference's float32, so the port's logits and gradients
differ from the reference's by a few bf16 roundings compounded over two
layers.  Measured over the six cases: logits within 2.3% of their
largest magnitude, each gradient leaf within 7.3% of its own largest, the
loss within 6.1e-4 relative; the bounds take two to three times that.  A
scan without its inter-chunk term moves the logits by 9.1% or more (25%
or more at 32 tokens, where the fault test runs) and some leaf by 55% or
more of its largest; one without D, the logits by 141% and more."""

import dataclasses
import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from plain import mamba2 as ref  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import ssm as pssm  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.tree import leaves, rebuild  # noqa: E402

LOGITS_BOUND = 0.05   # of the reference logits' largest magnitude
GRAD_BOUND = 0.15     # of each reference gradient leaf's largest entry
LOSS_RTOL = 2e-3


def smoke(tie: bool):
    return dataclasses.replace(get_smoke("mamba2-1.3b"), tie_embeddings=tie)


def scaled_params(cfg, seed: int) -> dict:
    """The port's params of ``cfg`` drawn so that each part of the mixer
    matters: projections at 1 / sqrt(fan-in), conv taps at 0.5, dt between
    softplus(-4) and softplus(-1) (decays that reach across chunks and
    die within a few), A from -1 to -8, D about 1, gains about 1."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, std=1.0):
        return std * torch.randn(*shape, generator=g)

    def u(lo, hi, k):
        return lo + (hi - lo) * torch.rand(k, generator=g)

    d, di, h, ns = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state
    fan_d, fan_i = d ** -0.5, di ** -0.5
    layers = [{"ln1": 1 + n(d, std=0.1), "ssm": pssm.Mamba2Params(
        wx=n(d, di, std=fan_d), wz=n(d, di, std=fan_d),
        wB=n(d, ns, std=fan_d), wC=n(d, ns, std=fan_d),
        wdt=n(d, h, std=fan_d), dt_bias=u(-4.0, -1.0, h),
        A_log=torch.log(u(1.0, 8.0, h)), D=1 + n(h, std=0.3),
        conv_x=n(pssm.CONV_TAPS, di, std=0.5),
        conv_B=n(pssm.CONV_TAPS, ns, std=0.5),
        conv_C=n(pssm.CONV_TAPS, ns, std=0.5),
        gate_norm=1 + n(di, std=0.1), wo=n(di, d, std=fan_i))}
        for _ in range(cfg.n_layers)]
    params = {"embed": n(cfg.vocab_size, d, std=0.2), "layers": layers,
              "final_norm": 1 + n(d, std=0.1)}
    if not cfg.tie_embeddings:
        params["head"] = n(d, cfg.vocab_size, std=fan_d)
    return params


def to_plain(params) -> dict:
    """The port's params in the reference's layout."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "layers": [{"norm": lp["ln1"], **lp["ssm"]._asdict()}
                      for lp in params["layers"]]}
    if "head" in params:
        out["head"] = params["head"]
    return out


def from_plain(grads) -> dict:
    """The reference's gradients in the port's layout."""
    out = {k: grads[k] for k in ("embed", "final_norm", "head")
           if k in grads}
    out["layers"] = [{"ln1": lp["norm"], "ssm": pssm.Mamba2Params(
        **{k: v for k, v in lp.items() if k != "norm"})}
        for lp in grads["layers"]]
    return out


def port_logits(cfg, params, tokens):
    with torch.no_grad():
        h = plm._embed(params, tokens)
        h, _, _ = plm._stack_forward(cfg, 1, params, h, collect_kv=False)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return plm._logits(params, h).float()


def batch(length: int, seed: int = 5, b: int = 2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (b, length), generator=g),
            torch.randint(0, 256, (b, length), generator=g))


def gaps(cfg, params, tokens, labels) -> dict:
    """The port's largest gaps to the reference: the logits', over the
    largest reference logit; each gradient leaf's, over the leaf's largest
    reference entry (the worst leaf); the loss's, relative."""
    fns = registry.build(cfg)
    live = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss = fns.loss(rebuild(params, live), {"tokens": tokens,
                                            "labels": labels})
    got = torch.autograd.grad(loss, live)
    want_loss, want = ref.loss_and_grads(to_plain(params), tokens, labels,
                                         remat=False)
    want = leaves(from_plain(want))
    assert len(got) == len(want)
    with torch.no_grad():
        want_logits = torch.stack([ref.logits(to_plain(params), t)
                                   for t in tokens])
    lg = port_logits(cfg, params, tokens)
    return {"logits": float((lg - want_logits).abs().max()
                            / want_logits.abs().max()),
            "grad": max(float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(got, want)),
            "loss": abs(float(loss.detach()) - float(want_loss))
            / float(want_loss)}


def recurrence(x, dt, A, B, C):
    """The state recurrence step by step: ``h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t B_t^T``, ``y_t = h_t C_t``."""
    h = torch.zeros(x.shape[1], x.shape[2], B.shape[1], dtype=x.dtype)
    ys = []
    for t in range(x.shape[0]):
        h = torch.exp(dt[t] * A)[:, None, None] * h \
            + (dt[t][:, None] * x[t])[..., None] * B[t]
        ys.append(h @ C[t])
    return torch.stack(ys)


@pytest.mark.parametrize("length", [1, 17, 64])
def test_the_matrix_form_is_the_recurrence(length):
    g = torch.Generator().manual_seed(length)
    h, p, n = 3, 4, 5
    x = torch.randn(length, h, p, generator=g, dtype=torch.float64)
    dt = 0.5 * torch.rand(length, h, generator=g, dtype=torch.float64)
    A = -(1 + 7 * torch.rand(h, generator=g, dtype=torch.float64))
    B = torch.randn(length, n, generator=g, dtype=torch.float64)
    C = torch.randn(length, n, generator=g, dtype=torch.float64)
    want = recurrence(x, dt, A, B, C)
    torch.testing.assert_close(ref.ssm(x, dt, A, B, C), want, rtol=1e-10,
                               atol=1e-12)
    # float32, as the reference runs: within its rounding
    got = ref.ssm(*(t.float() for t in (x, dt, A, B, C)))
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_segment_sums_are_the_segments_sums():
    a = torch.tensor([[1.0, 2.0, 4.0, 8.0]])
    s = ref.segsum(a)[0]
    assert s[3, 0] == 14.0 and s[3, 2] == 8.0 and s[2, 2] == 0.0
    assert torch.isneginf(s[0, 1]) and torch.isneginf(s[2, 3])


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("length", [32, 29, 13])
def test_the_port_matches_the_plain_reference(length, tie):
    """32: four whole chunks; 29 and 13 padded to chunks by the port."""
    cfg = smoke(tie)
    got = gaps(cfg, scaled_params(cfg, 3), *batch(length))
    assert got["logits"] <= LOGITS_BOUND, got
    assert got["grad"] <= GRAD_BOUND, got
    assert got["loss"] <= LOSS_RTOL, got


def _without_inter_chunk_term(x, dt, A, B, C, chunk):
    """The scan with each chunk computed as a sequence of its own: no state
    carried between chunks."""
    b, length, h, p = x.shape
    n, nc = B.shape[-1], max(length // chunk, 1)
    q = length // nc
    y, s = _REAL_SSD(x.reshape(b * nc, q, h, p), dt.reshape(b * nc, q, h),
                     A, B.reshape(b * nc, q, n), C.reshape(b * nc, q, n),
                     chunk)
    return y.reshape(b, length, h, p), s.reshape(b, nc, h, p, n)[:, -1]


def _without_D(*args, **kw):
    args = list(args)
    args[9] = args[9] * 0.0  # D
    return _REAL_CORE(*args, **kw)


_REAL_SSD, _REAL_CORE = pssm.ssd_chunked, pssm._mixer_core


@pytest.mark.parametrize("fault", ["inter_chunk", "D"])
def test_a_scan_missing_a_term_fails_the_bounds(fault, monkeypatch):
    if fault == "inter_chunk":
        monkeypatch.setattr(pssm, "ssd_chunked", _without_inter_chunk_term)
    else:
        monkeypatch.setattr(pssm, "_mixer_core", _without_D)
    cfg = smoke(True)
    got = gaps(cfg, scaled_params(cfg, 3), *batch(32))
    assert got["logits"] > 2 * LOGITS_BOUND and got["grad"] > 4 * GRAD_BOUND


def test_the_tied_head_is_one_leaf_whose_gradient_sums_both_uses():
    """Tied: no ``head`` leaf, and the embedding's gradient is what an
    untied model whose head is the embedding's transpose gives its
    embedding and its head together; the reference agrees."""
    tied = smoke(True)
    params = scaled_params(tied, 4)
    assert "head" not in params
    assert len(leaves(params)) == len(leaves(
        registry.build(tied).init(0, device="cpu")))
    untied = {**params, "head": params["embed"].t().contiguous()}
    tokens, labels = batch(24)
    b = {"tokens": tokens, "labels": labels}

    def grads(cfg, p):
        live = [t.detach().requires_grad_(True) for t in leaves(p)]
        loss = registry.build(cfg).loss(rebuild(p, live), b)
        return loss, rebuild(p, torch.autograd.grad(loss, live))

    lt, gt = grads(tied, params)
    lu, gu = grads(smoke(False), untied)
    assert float(lt.detach()) == pytest.approx(float(lu.detach()), rel=1e-6)
    both = gu["embed"] + gu["head"].t()
    torch.testing.assert_close(gt["embed"], both, rtol=1e-5, atol=1e-6)
    # each use alone is another gradient
    assert not torch.allclose(gt["embed"], gu["embed"], atol=1e-3)
    _, want = ref.loss_and_grads(to_plain(params), tokens, labels)
    err = (gt["embed"] - want["embed"]).abs().max()
    assert err <= GRAD_BOUND * want["embed"].abs().max()

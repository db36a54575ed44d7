"""Mamba-2 (Dao and Gu, "Transformers are SSMs", arXiv:2405.21060) as a
language model in plain PyTorch: the forward pass of the whole LM, its mean
next-token cross-entropy and the gradients by autograd, in float32 with
TF32 off (:func:`no_tf32`), with no chunking, no cache and no kernels.
Imports nothing but torch.

Params, a dict of float32 tensors, weights in the ``(in, out)`` layout:
``"embed"`` (V, d), ``"final_norm"`` (d,), ``"head"`` (d, V) or, for a
head tied to the embedding, no ``"head"`` (logits ``h @ embed^T``), and
``"layers"``, one dict a layer: ``"norm"`` (d,); the input projections
``"wx"``, ``"wz"`` (d, di), ``"wB"``, ``"wC"`` (d, N), ``"wdt"`` (d, H);
``"dt_bias"``, ``"A_log"``, ``"D"`` (H,); the causal convs' taps
``"conv_x"`` (W, di), ``"conv_B"``, ``"conv_C"`` (W, N); ``"gate_norm"``
(di,); ``"wo"`` (di, d).  The head dim is di / H; B and C are one group,
shared by every head.

A layer is ``u + Mixer(RMSNorm(u))``, no MLP.  The mixer:

* x, z, B, C, dt = u Wx, u Wz, u WB, u WC, u Wdt (the paper's ``in_proj``,
  split by output);
* x, B and C each through a depthwise causal conv of W taps, then SiLU;
* ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, one of each a head;
* per head, the state recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t
  B_t^T`` (h_t of shape (P, N)) with output ``y_t = h_t C_t + D x_t``;
* ``out_proj(RMSNorm(y * SiLU(z)))``.

After the last layer a final RMSNorm and the head.  The recurrence is
computed as the SSM's semiseparable matrix (the paper's section 3): per
head, ``y = (L o C B^T o dt[None, :]) x`` with ``L[i, j] = exp(sum_{k =
j+1..i} dt_k A)`` for i >= j and 0 above the diagonal.

Departures from the published model (``mamba_ssm``'s ``Mamba2``), each
the measured program's own, so that the two compute one function:

* the causal conv has no bias (the published one has);
* every RMSNorm takes eps 1e-5 and the gain after the normalisation;
* the exponents of ``L`` are segment sums, each a sum of the terms of its
  own segment (:func:`segsum`), not differences of one long prefix sum,
  whose rounding grows with the sequence;
* softplus is ``F.softplus`` (x itself above 20, a float32 rounding from
  ``log(1 + exp(x))``).

On the chip the loss and gradients of a whole batch come from
:func:`loss_and_grads`, one sequence at a time, each layer recomputed in
its backward, so that the reference fits beside the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-5


def no_tf32() -> None:
    """float32 products in float32: no TF32 in matrix products or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, gain):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS) \
        * gain


def silu(x):
    return x * torch.sigmoid(x)


def causal_conv(x, taps):
    """Depthwise causal conv. x (L, C), taps (W, C): ``y_t = sum_k taps[k]
    x[t - W + 1 + k]``, zeros before the start."""
    width, length = taps.shape[0], x.shape[0]
    padded = F.pad(x, (0, 0, width - 1, 0))
    return sum(taps[k] * padded[k:k + length] for k in range(width))


def segsum(a):
    """a (H, L) -> (H, L, L): ``[h, i, j] = sum_{k = j+1..i} a[h, k]`` for
    i >= j, -inf above the diagonal.  Each entry sums its own segment's
    terms: the column j of the strictly lower triangle of ``a[h, i]``
    summed down the rows."""
    n = a.shape[-1]
    ones = torch.ones((n, n), dtype=torch.bool, device=a.device)
    terms = a[..., :, None].expand(*a.shape, n).masked_fill(
        ~ones.tril(-1), 0.0)
    return torch.cumsum(terms, dim=-2).masked_fill(~ones.tril(), -torch.inf)


def ssm(x, dt, A, B, C):
    """The state-space recurrence as its semiseparable matrix. x (L, H, P),
    dt (L, H), A (H,), B and C (L, N) -> y (L, H, P), the recurrence's
    ``h_t C_t`` (without the D skip)."""
    decay = torch.exp(segsum((dt * A).T))             # (H, L, L)
    mat = decay * (C @ B.T) * dt.T[:, None, :]         # [h, i, j] by dt_j
    return torch.einsum("hij,jhp->ihp", mat, x)


def mixer(p, u):
    """The Mamba-2 mixer on one sequence u (L, d) -> (L, d)."""
    length = u.shape[0]
    x, z = u @ p["wx"], u @ p["wz"]
    B, C, dt = u @ p["wB"], u @ p["wC"], u @ p["wdt"]
    x = silu(causal_conv(x, p["conv_x"]))
    B = silu(causal_conv(B, p["conv_B"]))
    C = silu(causal_conv(C, p["conv_C"]))
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(length, A.shape[0], -1)
    y = ssm(xh, dt, A, B, C) + p["D"][None, :, None] * xh
    return rms_norm(y.reshape(length, -1) * silu(z), p["gate_norm"]) \
        @ p["wo"]


def layer(p, u):
    return u + mixer(p, rms_norm(u, p["norm"]))


def logits(params, tokens, *, remat: bool = False):
    """tokens (L,) int -> (L, V): the LM's logits for one sequence, each
    layer recomputed in the backward with ``remat``."""
    h = params["embed"][tokens]
    for p in params["layers"]:
        h = checkpoint(layer, p, h, use_reentrant=False) if remat \
            else layer(p, h)
    head = params["head"] if "head" in params else params["embed"].T
    return rms_norm(h, params["final_norm"]) @ head


def loss_and_grads(params, tokens, labels, *, remat: bool = True):
    """The mean next-token cross-entropy over every position of tokens
    and labels (B, L), and its gradient, a dict shaped as ``params``:
    one sequence at a time, each layer recomputed in its backward
    (``remat``), the sequences' gradients summed."""
    live = {k: [{n: t.detach().requires_grad_(True) for n, t in p.items()}
                for p in v] if k == "layers" else v.detach().requires_grad_(True)
            for k, v in params.items()}
    count = tokens.numel()
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    with torch.enable_grad():
        for b in range(tokens.shape[0]):
            part = F.cross_entropy(logits(live, tokens[b], remat=remat),
                                   labels[b], reduction="sum") / count
            part.backward()
            total = total + part.detach()
    grads = {k: [{n: t.grad for n, t in p.items()} for p in v]
             if k == "layers" else v.grad for k, v in live.items()}
    return total, grads

"""Mamba-2 mixer (counterpart of ``repro.models.ssm``): the SSD (state-space
duality) scan, chunked — quadratic within a chunk, recurrent across chunks
(arXiv:2405.21060) — and the single-token decode step.

Per head h with state size N and head dim P:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t + D * x_t

The reference computes the scan with XLA einsums and a ``lax.scan`` over
chunks (no Pallas kernel), so the port's is plain PyTorch: batched matrix
products in f32 and a Python loop over chunks that carries the state.
Every elementwise step runs in the reference's order and dtype: the causal
conv sums four bf16 products in Python order from 0, SiLU is
``models.mlp.silu`` (the reference's lowering), softplus is
``jax.nn.softplus``'s ``logaddexp(x, 0)``, the gate norm takes
``rms_norm``'s default eps.  The products inside the scan sum in
PyTorch's order, so the scan holds the reference within an f32 tolerance.
The chunks' log-decay prefix sums are f64 products (:func:`prefix_sum`,
the CPU ``cumsum``'s values), which the card computes deterministically,
forward and backward: LM training holds deterministic algorithms.

The decode cache, :class:`Mamba2Cache`, holds the f32 state (B, H, P, N)
and the last ``CONV_TAPS - 1`` bf16 projections of x, B and C; decode
updates it in place.  A prompt shorter than that tail is refused: the
reference's prefill would hand decode a tail too short to extend.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch import obs
from repro_torch.dist.sharding import (grad_placed_as, grad_placements,
                                       rules_placements, shard)
from repro_torch.models.common import COMPUTE, dense, normal_init, rms_norm
from repro_torch.models.mlp import silu

CONV_TAPS = 4  # the depthwise causal conv's width
#: params the mixer reads in f32: a bf16 serving copy keeps their masters
FP32_FIELDS = ("dt_bias", "A_log", "D")


class Mamba2Params(NamedTuple):
    wx: torch.Tensor         # (d, di)
    wz: torch.Tensor         # (d, di)
    wB: torch.Tensor         # (d, N)
    wC: torch.Tensor         # (d, N)
    wdt: torch.Tensor        # (d, H)
    dt_bias: torch.Tensor    # (H,)
    A_log: torch.Tensor      # (H,)
    D: torch.Tensor          # (H,)
    conv_x: torch.Tensor     # (CONV_TAPS, di) depthwise
    conv_B: torch.Tensor     # (CONV_TAPS, N)
    conv_C: torch.Tensor     # (CONV_TAPS, N)
    gate_norm: torch.Tensor  # (di,)
    wo: torch.Tensor         # (di, d)


class Mamba2Cache(NamedTuple):
    state: torch.Tensor      # (B, H, P, N) f32
    conv_x: torch.Tensor     # (B, CONV_TAPS - 1, di) bf16
    conv_B: torch.Tensor     # (B, CONV_TAPS - 1, N) bf16
    conv_C: torch.Tensor     # (B, CONV_TAPS - 1, N) bf16


def init_ssm(generator, d_model, d_inner, n_state, n_heads,
             device=None) -> Mamba2Params:
    """The reference's init: normal projections, ``dt_bias`` the inverse
    softplus of 0.01, ``A_log`` spread over log 1..16, ``D`` and the gate
    norm ones."""
    def normal(shape, scale=0.02):
        return normal_init(generator, shape, scale, device=device)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    return Mamba2Params(
        wx=normal((d_model, d_inner)), wz=normal((d_model, d_inner)),
        wB=normal((d_model, n_state)), wC=normal((d_model, n_state)),
        wdt=normal((d_model, n_heads)),
        dt_bias=torch.log(torch.expm1(torch.full(
            (n_heads,), 0.01, dtype=torch.float32, device=device))),
        A_log=torch.log(torch.linspace(1.0, 16.0, n_heads,
                                       dtype=torch.float32, device=device)),
        D=ones(n_heads),
        conv_x=normal((CONV_TAPS, d_inner), 0.1),
        conv_B=normal((CONV_TAPS, n_state), 0.1),
        conv_C=normal((CONV_TAPS, n_state), 0.1),
        gate_norm=ones(d_inner), wo=normal((d_inner, d_model)))


def ssm_axes() -> Mamba2Params:
    """One layer's logical axes (the reference's without its leading
    stacked-layer ``None``): heads and the inner width over ``"tp"``."""
    return Mamba2Params(
        wx=("fsdp", "tp"), wz=("fsdp", "tp"), wB=("fsdp", None),
        wC=("fsdp", None), wdt=("fsdp", "tp"), dt_bias=("tp",),
        A_log=("tp",), D=("tp",), conv_x=(None, "tp"), conv_B=(None, None),
        conv_C=(None, None), gate_norm=("tp",), wo=("tp", "fsdp"))


def cache_axes() -> Mamba2Cache:
    """A layer's cache axes (the reference's per-layer hybrid entry)."""
    return Mamba2Cache(state=("batch", "tp", None, None),
                       conv_x=("batch", None, "tp"),
                       conv_B=("batch", None, None),
                       conv_C=("batch", None, None))


def init_cache(batch, n_heads, head_dim, n_state, d_inner, *,
               device=None) -> Mamba2Cache:
    """A zeroed decode cache."""
    def tail(width):
        return torch.zeros((batch, CONV_TAPS - 1, width), dtype=COMPUTE,
                           device=device)

    return Mamba2Cache(
        state=torch.zeros((batch, n_heads, head_dim, n_state),
                          dtype=torch.float32, device=device),
        conv_x=tail(d_inner), conv_B=tail(n_state), conv_C=tail(n_state))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` as JAX computes it:
    ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` returns x above 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def check_prompt_len(length: int) -> None:
    """Refuse a prompt too short to leave decode its conv tail."""
    if length < CONV_TAPS - 1:
        raise ValueError(
            f"an SSM prompt of {length} token(s) leaves a conv tail shorter "
            f"than the {CONV_TAPS - 1} tokens decode extends; prompts need "
            f"at least {CONV_TAPS - 1} tokens")


def _causal_conv(x, w):
    """Depthwise causal conv. x: (B, L, D); w: (W, D).  The W products are
    summed in x's dtype in order, from 0, as the reference's ``sum``."""
    taps, length = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, taps - 1, 0))
    out = 0
    for i in range(taps):
        out = out + xp[:, i:i + length] * w[i]
    return out


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)`` of an f32 tensor, as a product with a
    lower-triangular matrix of ones in f64, rounded back to f32.  The CPU's
    ``cumsum`` sums f32 in f64 too, so the values are its own; on CUDA a
    floating-point ``cumsum`` has no deterministic implementation (it
    raises under ``torch.use_deterministic_algorithms``, which LM training
    holds), the f64 product has one, and its backward is another."""
    n = x.shape[dim]
    ones = torch.ones((n, n), dtype=torch.float64, device=x.device).tril()
    moved = x.movedim(dim, -1).double()
    return torch.matmul(moved, ones.T).to(x.dtype).movedim(-1, dim)


def ssd_chunked(x, dt, A, Bmat, Cmat, chunk: int):
    """Chunked SSD scan, f32.

    x: (B, L, H, P); dt: (B, L, H) (after softplus); A: (H,) negative;
    Bmat/Cmat: (B, L, N).  Returns (y (B, L, H, P), final state
    (B, H, P, N)).  L must be a multiple of ``chunk`` or shorter than it."""
    b, length, h, p = x.shape
    n = Bmat.shape[-1]
    nc = max(length // chunk, 1)
    q = length // nc
    if length % q:
        raise ValueError(f"length {length} is not a multiple of the chunk "
                         f"{chunk}")
    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h)
    br = Bmat.reshape(b, nc, q, n)
    cr = Cmat.reshape(b, nc, q, n)
    cum = prefix_sum(dtr * A, dim=2)                # (B,nc,Q,H) log-decay

    # within a chunk, per head (the dual quadratic form): (B,nc,H,Q,K)
    cum_h = cum.transpose(2, 3)
    cb = torch.matmul(cr, br.transpose(2, 3))       # (B,nc,Q,K)
    # above the diagonal the exponent is >= 0 and may overflow to inf: it is
    # masked before exp (to 0) and the entries selected away after, so
    # neither the values nor the gradient meet an inf (0 * inf is NaN; the
    # reference masks only after exp, and its gradient is NaN there).  Out
    # of place, so autograd can differentiate it; the values are the
    # in-place form's bit for bit.
    upper = torch.ones((q, q), dtype=torch.bool, device=x.device).triu(1)
    m = torch.exp(torch.where(upper, 0.0,
                              cum_h[..., :, None] - cum_h[..., None, :])) \
        * cb[:, :, None] * dtr.transpose(2, 3)[:, :, :, None, :]
    m = torch.where(upper, 0.0, m)
    y = torch.matmul(m, xr.transpose(2, 3)).transpose(2, 3)  # (B,nc,Q,H,P)

    # each chunk's contribution to the state at its end: (B,nc,H,P,N)
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dtr
    s_chunk = torch.einsum("bcqhp,bcqn->bchpn", xr * w_end[..., None], br)

    # across chunks: the state entering each chunk, then its outputs
    decay = torch.exp(cum[:, :, -1])                # (B,nc,H)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = decay[:, c, :, None, None] * state + s_chunk[:, c]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cr, torch.stack(entering, 1))
    y = y + y_inter * torch.exp(cum)[..., None]
    return y.reshape(b, length, h, p), state


def _mixer_core(x_raw, bm_raw, cm_raw, dt_raw, conv_x, conv_B, conv_C,
                dt_bias, A_log, D, *, head_dim: int, chunk: int):
    """The mixer between its input projections and its gate: the causal
    convs and SiLU, dt, the chunked scan over the heads of ``x_raw`` (B, L,
    H*P), the skip ``D``.  Returns (y (B, L, H*P) in ``x_raw``'s dtype, the
    final state (B, H, P, N)).  Each head is independent, so the block runs
    per rank on a rank's own heads (:func:`ssm_block`).  The scan is the
    span ``model.ssd`` (counter ``ssd_calls``), its backward the span
    ``model.ssd_bwd`` (``obs.backward_span``)."""
    b, length, _ = x_raw.shape
    x = silu(_causal_conv(x_raw, conv_x.to(x_raw.dtype)))
    bm = silu(_causal_conv(bm_raw, conv_B.to(bm_raw.dtype)))
    cm = silu(_causal_conv(cm_raw, conv_C.to(cm_raw.dtype)))
    dt = softplus(dt_raw.float() + dt_bias)
    a = -torch.exp(A_log.float())
    # the sequence padded to a chunk multiple; dt = 0 on the padding gives
    # decay 1 and no update, so the final state is the unpadded one
    pad = (-length) % min(chunk, max(length, 1))
    if pad:
        x, bm, cm, dt = (F.pad(t, (0, 0, 0, pad)) for t in (x, bm, cm, dt))
        dt = dt * (torch.arange(length + pad, device=x.device)
                   < length)[None, :, None]
    xh = x.reshape(b, length + pad, -1, head_dim).float()
    obs.count("ssd_calls")
    with obs.span("repro_torch.model.ssd"):
        scan = obs.backward_span("repro_torch.model.ssd_bwd", xh, dt, a,
                                 bm.float(), cm.float(),
                                 counter="ssd_bwd_calls")
        y, state = ssd_chunked(*scan.inputs, chunk)
        scan.mark(y, state)
    y = y + D[None, None, :, None] * xh
    return y.reshape(b, length + pad, -1)[:, :length].to(x_raw.dtype), state


def ssm_block(p: Mamba2Params, u, *, n_heads, head_dim, n_state, chunk,
              quant="none", return_cache=False):
    """The mamba2 mixer. u: (B, L, d) -> (B, L, d) [, Mamba2Cache].

    A DTensor ``u`` runs the projections as DTensor ops, the convs and the
    scan (:func:`_mixer_core`) per rank in ``local_map`` on the rank's rows
    and heads (``("batch", None, "tp")``), and the gate norm again as
    DTensor ops: its mean is over the whole inner width, which ``model``
    splits, so it is reduced over ``model`` (a per-rank norm of each slice
    would be another function).  The gate ``z`` takes its gradient as
    :func:`_gate_grad_placements` places it."""
    b, length, _ = u.shape
    if return_cache:
        check_prompt_len(length)
    x_raw = dense(u, p.wx, quant=quant)             # (B,L,di)
    z = dense(u, p.wz, quant=quant)
    if isinstance(z, DTensor) and z.device_mesh.size() > 1:
        z = grad_placed_as(z, _gate_grad_placements(z))
    bm_raw = dense(u, p.wB)
    cm_raw = dense(u, p.wC)
    dt_raw = dense(u, p.wdt)
    core = partial(_mixer_core, head_dim=head_dim, chunk=chunk)
    args = (x_raw, bm_raw, cm_raw, dt_raw, p.conv_x, p.conv_B, p.conv_C,
            p.dt_bias, p.A_log, p.D)
    if isinstance(u, DTensor):
        core = _per_rank_heads(core, u)
    y, state = core(*args)
    y = rms_norm(y * silu(z), p.gate_norm)
    out = dense(y, p.wo, quant=quant)
    if not return_cache:
        return out

    def tail(t, axes):  # from the unpadded projections, placed by axes
        return shard(t[:, length - (CONV_TAPS - 1):].to(COMPUTE, copy=True),
                     *axes)

    ax = cache_axes()
    return out, Mamba2Cache(state=state, conv_x=tail(x_raw, ax.conv_x),
                            conv_B=tail(bm_raw, ax.conv_B),
                            conv_C=tail(cm_raw, ax.conv_C))


def _gate_grad_placements(z) -> tuple:
    """Where the gate ``z``'s gradient goes on a ``model`` dim: split along
    the rank's rows, where DTensor's backward of the gate norm splits it,
    or, where the rows do not split over ``model``, as ``z`` itself (the
    inner width).  Left to DTensor there (4 rows a card at pod 2 x data 32
    x model 8), the gradient came back whole and ``wz``'s weight gradient
    ran at the full inner width on every ``model`` rank."""
    rows = z.to_local().shape[0]
    return tuple(
        Shard(0) if isinstance(p, Shard) and p.dim == 2
        and rows % z.device_mesh.size(i) == 0 else p
        for i, p in enumerate(rules_placements(("batch", None, "tp"), z)))


def _per_rank_heads(core, ref):
    """``core`` (:func:`_mixer_core`) in ``local_map`` on ``ref``'s mesh:
    the rows over the batch's dims, the heads (and the inner width) over
    ``tp``'s, placed by the ambient rules; B, C and the gradients of what
    every head reads summed over the heads' ranks."""
    from torch.distributed.tensor.experimental import local_map

    def pl(*axes):
        return rules_placements(axes, ref)

    inner, rows, heads = pl("batch", None, "tp"), pl("batch", None, None), \
        pl("tp")
    taps_x, taps = pl(None, "tp"), pl(None, None)
    state = pl("batch", "tp", None, None)
    ins = (inner, rows, rows, inner, taps_x, taps, taps, heads, heads, heads)
    return local_map(core, out_placements=(inner, state), in_placements=ins,
                     in_grad_placements=tuple(grad_placements(i, inner, state)
                                              for i in ins),
                     device_mesh=ref.device_mesh, redistribute_inputs=True)


def _conv_step(cache, new, w):
    """cache: (B, W-1, D), shifted in place to end with ``new`` (B, D); w:
    (W, D).  Returns the conv's output (B, D): the W products summed in f32
    and rounded to ``new``'s dtype, as the reference's ``jnp.sum``."""
    window = torch.cat([cache.to(new.dtype), new[:, None]], dim=1)
    out = (window * w).sum(dim=1, dtype=torch.float32).to(new.dtype)
    cache.copy_(window[:, 1:])
    return out


def ssm_decode_step(p: Mamba2Params, cache: Mamba2Cache, u1, *, n_heads,
                    head_dim, n_state, quant="none"):
    """u1: (B, d) one token.  Updates ``cache`` in place; returns (y1,
    cache)."""
    b = u1.shape[0]
    x = dense(u1, p.wx, quant=quant)
    z = dense(u1, p.wz, quant=quant)
    bm = dense(u1, p.wB)
    cm = dense(u1, p.wC)
    dt_raw = dense(u1, p.wdt)
    x = silu(_conv_step(cache.conv_x, x, p.conv_x.to(x.dtype)))
    bm = silu(_conv_step(cache.conv_B, bm, p.conv_B.to(bm.dtype)))
    cm = silu(_conv_step(cache.conv_C, cm, p.conv_C.to(cm.dtype)))
    dt = softplus(dt_raw.float() + p.dt_bias)                    # (B,H)
    a = -torch.exp(p.A_log.float())
    xh = x.reshape(b, n_heads, head_dim).float()
    decay = torch.exp(dt * a[None, :])
    upd = (dt[:, :, None] * xh)[..., None] * bm.float()[:, None, None, :]
    cache.state.mul_(decay[:, :, None, None]).add_(upd)
    y = torch.einsum("bn,bhpn->bhp", cm.float(), cache.state)
    y = y + p.D[None, :, None] * xh
    y = y.reshape(b, -1).to(u1.dtype)
    y = rms_norm(y * silu(z), p.gate_norm)
    return dense(y, p.wo, quant=quant), cache

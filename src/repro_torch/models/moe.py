"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``): top-k
routing with a capacity per expert and group (GShard / T5X style), SiLU-gated
experts and dense shared experts (DeepSeekMoE).

Tokens go in groups of ``group_size`` consecutive rows of the ``(B*S, d)``
tokens; a group gives each expert ``C = max(ceil(gs * k * cf / E), 4)``
slots.  Choice ``j`` of every token is placed after all choices ``< j`` of
the group, and within a choice in token order: a token's slot is the count
of earlier tokens of its group sent to the same expert.  A token past its
expert's capacity is dropped from that expert and passes through the
residual.  At decode the one group is the whole batch, so one request's
routing can take the slot another request's token wanted — the reference's
semantics, kept.

Two forms compute the same function:

* :func:`moe_block_plain` builds the reference's dense one-hot
  ``(G, s, E, C)`` dispatch and combine literally (``dense_combine``) and
  contracts them by einsum.  It is the tests' oracle.
* :func:`moe_block`, the model's path, places each kept (token, choice) by
  its slot index (:func:`slots`) into an expert-major buffer holding the
  same rows, and gathers the outputs back with the same gates.  The
  experts' products are shared (``_experts``).  Routing, drops and the
  experts' inputs are equal to the plain form's; the combine sums each
  token's k products in its own order (``tests/test_torch_moe.py`` holds
  both).  At deepseek-moe-16b's prefill shape on an H100 it is the faster
  of the two (``chip_smoke.py`` times both).

No Pallas kernel backs MoE in the reference (XLA einsums); here the products
are PyTorch matmuls.  Nothing here synchronises with the host: drops are
masked, never filtered out.

Under grad both forms are the reference's function: the router's gradient
flows through the softmax and the renormalised top-k gates (the sort's
backward scatters them back) and through the balance term, x's through the
gathers and the shared experts, the experts' through their products.  On
the card under ``torch.use_deterministic_algorithms`` (LM training) every
op of the index form has a deterministic implementation: the scatter of
the token indices, the gathers whose backward is an accumulating
``index_put_`` (sorted on CUDA), the sort and the integer ``cumsum`` of
:func:`slots`.  The plain form's float ``cumsum`` (``dense_combine``) has
none and raises there; it is the tests' oracle, not the model's path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.dist.sharding import shard
from repro_torch.models.common import normal_init
from repro_torch.models.mlp import (MlpParams, init_mlp, mlp_axes, mlp_block,
                                    silu)


GROUP_SIZE = 256  # tokens a routing group holds (the reference's default)


class MoeParams(NamedTuple):
    router: torch.Tensor           # (d, E), used in f32
    w_gate: torch.Tensor           # (E, d, ff)
    w_in: torch.Tensor             # (E, d, ff)
    w_out: torch.Tensor            # (E, ff, d)
    shared: MlpParams | None       # dense shared experts, width n_shared * ff


class Routing(NamedTuple):
    probs: torch.Tensor   # (G, s, E) f32 router softmax
    gates: torch.Tensor   # (G, s, k) f32 top-k probabilities, renormalised
    idx: torch.Tensor     # (G, s, k) int64 experts, in priority order
    capacity: int         # slots an expert has in a group


def init_moe(generator, d_model, d_ff, n_experts, n_shared, gated=True,
             device=None) -> MoeParams:
    def normal(shape):
        return normal_init(generator, shape, device=device)

    return MoeParams(
        router=normal((d_model, n_experts)),
        w_gate=normal((n_experts, d_model, d_ff)),
        w_in=normal((n_experts, d_model, d_ff)),
        w_out=normal((n_experts, d_ff, d_model)),
        shared=(init_mlp(generator, d_model, n_shared * d_ff, gated,
                         device=device) if n_shared else None))


def moe_axes(n_shared, gated=True) -> MoeParams:
    """One layer's logical axes (the reference's without its leading
    stacked-layer ``None``): the experts over ``"tp"``."""
    return MoeParams(router=("fsdp", None),
                     w_gate=("tp", "fsdp", None), w_in=("tp", "fsdp", None),
                     w_out=("tp", None, "fsdp"),
                     shared=mlp_axes(gated) if n_shared else None)


def _group_axes(n_groups: int) -> tuple:
    """Groups carry the batch's sharding when there are several; the one
    group of a decode step keeps its tokens sharded instead (the
    reference's)."""
    return ("batch", None, None) if n_groups > 1 else (None, "batch", None)


def capacity_of(group: int, top_k: int, capacity_factor: float,
                n_experts: int) -> int:
    """Slots an expert has in a group of ``group`` tokens."""
    return max(int(math.ceil(group * top_k * capacity_factor / n_experts)), 4)


def group_of(n_tokens: int, group_size: int = GROUP_SIZE) -> int:
    """The routing group of ``n_tokens`` tokens, ``min(group_size, n)``;
    raises ``ValueError`` when the tokens are not a whole number of groups
    (the reference asserts it) rather than padding."""
    gs = min(group_size, n_tokens)
    if n_tokens % gs:
        raise ValueError(
            f"MoE: {n_tokens} tokens (batch x sequence) are not a whole "
            f"number of routing groups of {gs}; the reference refuses this "
            f"too (moe_block asserts n % group_size == 0). Choose batch x "
            f"sequence as a multiple of {gs}.")
    return gs


def _groups(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """(B, S, d) -> (G, gs, d), groups of consecutive tokens."""
    n = x.shape[0] * x.shape[1]
    gs = group_of(n, group_size)
    return x.reshape(n // gs, gs, x.shape[-1])


def _one_hot(i: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: f32, all zeros for an index outside [0, n)."""
    return (i[..., None] == torch.arange(n, device=i.device)).float()


def route(router: torch.Tensor, xg: torch.Tensor, top_k: int,
          capacity_factor: float) -> Routing:
    """Router logits in f32, softmax, top-k (ties to the lower expert index,
    as ``lax.top_k``: a stable sort), gates renormalised over the k."""
    logits = torch.matmul(xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[..., :top_k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    cap = capacity_of(xg.shape[1], top_k, capacity_factor, router.shape[-1])
    return Routing(probs, gates, order[..., :top_k], cap)


def dense_combine(r: Routing, n_experts: int) -> torch.Tensor:
    """The reference's combine tensor ``(G, s, E, C)`` in f32, built as it
    builds it: for each choice in priority order, each token's slot is a
    cumulative count over the group's one-hots plus ``base``, the slots the
    earlier choices filled."""
    g = r.idx.shape[0]
    combine = torch.zeros((*r.idx.shape[:2], n_experts, r.capacity),
                          dtype=torch.float32, device=r.idx.device)
    base = torch.zeros((g, n_experts), dtype=torch.float32,
                       device=r.idx.device)
    for j in range(r.idx.shape[-1]):
        onehot = _one_hot(r.idx[:, :, j], n_experts)            # (G, s, E)
        pos = torch.cumsum(onehot, dim=1) - 1.0 + base[:, None, :]
        within = (pos < r.capacity) & (onehot > 0)
        slot = _one_hot(pos.to(torch.int32), r.capacity)       # (G, s, E, C)
        combine += (r.gates[:, :, j, None, None]
                    * torch.where(within[..., None], onehot[..., None] * slot,
                                  0.0))
        base += torch.sum(onehot * within, dim=1)
    return combine


def slots(r: Routing, n_experts: int) -> tuple:
    """(slot, keep), each ``(G, s, k)``: the slot each (token, choice) takes
    in its expert, by the same cumulative count as :func:`dense_combine`,
    and whether it is dispatched — within capacity and with a gate above
    zero (the reference dispatches where ``combine > 0``)."""
    base = torch.zeros((r.idx.shape[0], 1, n_experts), dtype=torch.int64,
                       device=r.idx.device)
    pos = []
    for j in range(r.idx.shape[-1]):
        choice = r.idx[:, :, j:j + 1]
        onehot = (choice == torch.arange(n_experts, device=choice.device)
                  ).to(torch.int64)                            # (G, s, E)
        count = torch.cumsum(onehot, dim=1) - 1 + base
        p = torch.gather(count, 2, choice)[..., 0]             # (G, s)
        base = base + torch.sum(onehot * (p < r.capacity)[..., None], dim=1,
                                keepdim=True)
        pos.append(p)
    slot = torch.stack(pos, dim=-1)
    return slot, (slot < r.capacity) & (r.gates > 0)


def _experts(p: MoeParams, expert_in: torch.Tensor) -> torch.Tensor:
    """SiLU-gated expert FFNs over each expert's slots: (E, N, d) -> (E, N,
    d), one batched product over the experts, weights cast to the
    activations' dtype."""
    dt = expert_in.dtype
    h = silu(torch.bmm(expert_in, p.w_gate.to(dt))) * torch.bmm(
        expert_in, p.w_in.to(dt))
    return torch.bmm(h, p.w_out.to(dt))


def _finish(p: MoeParams, x, y, r: Routing, quant: str) -> tuple:
    """Shared experts added (their projections the only ones ``quant``
    reaches, as in the reference); the Switch load-balance loss."""
    n_exp = r.probs.shape[-1]
    frac_tokens = torch.mean(_one_hot(r.idx[:, :, 0], n_exp), dim=(0, 1))
    frac_probs = torch.mean(r.probs, dim=(0, 1))
    aux = n_exp * torch.sum(frac_tokens * frac_probs)
    if p.shared is not None:
        y = y + mlp_block(p.shared, x, quant=quant)
    return y, aux


def moe_block_plain(p: MoeParams, x, *, top_k: int,
                    capacity_factor: float = 1.25,
                    group_size: int = GROUP_SIZE, quant: str = "none"):
    """x: (B, S, d) -> (y, aux) through the dense one-hot dispatch and
    combine, as the reference computes them."""
    xg = _groups(x, group_size)
    n_groups, _, d = xg.shape
    r = route(p.router, xg, top_k, capacity_factor)
    n_exp = p.router.shape[-1]
    combine = dense_combine(r, n_exp)
    dispatch = (combine > 0.0).to(x.dtype)
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)
    expert_out = _experts(p, expert_in.reshape(n_exp, -1, d)).view(
        n_exp, n_groups, r.capacity, d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), expert_out)
    return _finish(p, x, y.reshape(x.shape), r, quant)


def moe_block(p: MoeParams, x, *, top_k: int, capacity_factor: float = 1.25,
              group_size: int = GROUP_SIZE, quant: str = "none"):
    """x: (B, S, d) -> (y, aux).  Dropped tokens pass through the residual.

    The expert buffer is expert-major: each kept (token, choice) takes row
    ``(e*G + g)*C + slot``, so the experts are one batched product over
    ``e`` with no transposes.  The buffer is gathered, not scattered: each
    row reads the token that fills it, or a zero row past the tokens when
    none does.  Back, each token gathers its k rows (a dropped choice reads
    any row, with weight zero)."""
    xg = _groups(x, group_size)
    n_groups, gs, d = xg.shape
    xg = shard(xg, *_group_axes(n_groups))
    n_tok, n_exp = n_groups * gs, p.router.shape[-1]
    r = route(p.router, xg, top_k, capacity_factor)
    slot, keep = slots(r, n_exp)
    n_slots = n_exp * n_groups * r.capacity
    group = torch.arange(n_groups, device=x.device)[:, None, None]
    row = torch.where(keep, (r.idx * n_groups + group) * r.capacity + slot,
                      n_slots)                                  # (G, s, k)
    # the token each row holds; the dropped choices all land on a spare
    # entry past the rows, which is never read
    token = torch.arange(n_tok, device=x.device).view(n_groups, gs, 1)
    src = torch.full((n_slots + 1,), n_tok, dtype=torch.int64,
                     device=x.device)
    src.scatter_(0, row.reshape(-1), token.expand(-1, -1, top_k).reshape(-1))
    tokens = torch.cat([xg.reshape(n_tok, d), xg.new_zeros((1, d))])
    expert_in = shard(tokens[src[:n_slots]].view(n_exp, -1, d),
                      "tp", None, None)
    expert_out = shard(_experts(p, expert_in), "tp", None, None)
    # the combine weights cast to the activations' dtype, as the reference
    # casts its combine tensor; each token's k products summed
    w = torch.where(keep, r.gates, 0.0).to(x.dtype)
    picked = expert_out.view(n_slots, d)[torch.clamp(row, max=n_slots - 1)]
    y = torch.matmul(w[..., None, :], picked).squeeze(-2)       # (G, s, d)
    return _finish(p, x, y.reshape(x.shape), r, quant)

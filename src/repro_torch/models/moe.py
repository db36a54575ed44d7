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

Under a mesh (a DTensor x) the block runs expert-parallel over ``model``
(:func:`_moe_block_sharded`): routing per rank on its own groups, each
rank's E/tp experts, the outputs all-gathered over ``model`` for the
combine, the balance term's means reduced over the batch's mesh dims.

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist.sharding import grad_placements, rules_placements
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


def _experts(expert_in, w_gate, w_in, w_out) -> torch.Tensor:
    """SiLU-gated expert FFNs over each expert's slots: (E, N, d) -> (E, N,
    d), one batched product over the experts, weights cast to the
    activations' dtype."""
    dt = expert_in.dtype
    h = silu(torch.bmm(expert_in, w_gate.to(dt))) * torch.bmm(
        expert_in, w_in.to(dt))
    return torch.bmm(h, w_out.to(dt))


def _balance(r: Routing) -> tuple:
    """The Switch load-balance term's two means over the groups' tokens,
    each (E,): the share of tokens whose first choice is each expert, and
    the mean router probability of each."""
    n_exp = r.probs.shape[-1]
    return (torch.mean(_one_hot(r.idx[:, :, 0], n_exp), dim=(0, 1)),
            torch.mean(r.probs, dim=(0, 1)))


def _finish(p: MoeParams, x, y, fracs: tuple, quant: str) -> tuple:
    """Shared experts added (their projections the only ones ``quant``
    reaches, as in the reference); the Switch load-balance loss, ``E *
    sum(frac_tokens * frac_probs)``: the product taken after the means."""
    frac_tokens, frac_probs = fracs
    aux = frac_tokens.shape[-1] * torch.sum(frac_tokens * frac_probs)
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
    expert_out = _experts(expert_in.reshape(n_exp, -1, d), p.w_gate,
                          p.w_in, p.w_out).view(n_exp, n_groups,
                                                r.capacity, d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), expert_out)
    return _finish(p, x, y.reshape(x.shape), _balance(r), quant)


def _dispatch(router, xg, top_k: int, capacity_factor: float) -> tuple:
    """Routing and the expert-major buffer of the groups xg (G, gs, d):
    (expert_in (E, G*C, d), the combine weights (G, gs, k) f32 — the gates
    of the kept choices, 0 elsewhere —, each choice's row (G, gs, k), the
    balance term's two means).  Each kept (token, choice) takes row
    ``(e*G + g)*C + slot``; the buffer is gathered, not scattered: each row
    reads the token that fills it, or a zero row past the tokens when none
    does."""
    n_groups, gs, d = xg.shape
    n_tok, n_exp = n_groups * gs, router.shape[-1]
    r = route(router, xg, top_k, capacity_factor)
    slot, keep = slots(r, n_exp)
    n_slots = n_exp * n_groups * r.capacity
    group = torch.arange(n_groups, device=xg.device)[:, None, None]
    row = torch.where(keep, (r.idx * n_groups + group) * r.capacity + slot,
                      n_slots)                                  # (G, s, k)
    # the token each row holds; the dropped choices all land on a spare
    # entry past the rows, which is never read
    token = torch.arange(n_tok, device=xg.device).view(n_groups, gs, 1)
    src = torch.full((n_slots + 1,), n_tok, dtype=torch.int64,
                     device=xg.device)
    src.scatter_(0, row.reshape(-1), token.expand(-1, -1, top_k).reshape(-1))
    tokens = torch.cat([xg.reshape(n_tok, d), xg.new_zeros((1, d))])
    expert_in = tokens[src[:n_slots]].view(n_exp, -1, d)
    return (expert_in, torch.where(keep, r.gates, 0.0), row,
            *_balance(r))


def _combine(expert_out, w, row) -> torch.Tensor:
    """Each token's k rows of ``expert_out`` (E, G*C, d), weighted by ``w``
    (G, gs, k) cast to the activations' dtype, as the reference casts its
    combine tensor, and summed: (G, gs, d).  A dropped choice reads any
    row, with weight zero."""
    n_slots = expert_out.shape[0] * expert_out.shape[1]
    picked = expert_out.view(n_slots, expert_out.shape[-1])[
        torch.clamp(row, max=n_slots - 1)]
    return torch.matmul(w.to(expert_out.dtype)[..., None, :],
                        picked).squeeze(-2)


def moe_block(p: MoeParams, x, *, top_k: int, capacity_factor: float = 1.25,
              group_size: int = GROUP_SIZE, quant: str = "none"):
    """x: (B, S, d) -> (y, aux).  Dropped tokens pass through the residual.

    The expert buffer is expert-major (:func:`_dispatch`), so the experts
    are one batched product over ``e`` with no transposes; back, each
    token gathers its k rows (:func:`_combine`).  A DTensor ``x`` runs
    expert-parallel (:func:`_moe_block_sharded`)."""
    if isinstance(x, DTensor):
        return _moe_block_sharded(p, x, top_k=top_k,
                                  capacity_factor=capacity_factor,
                                  group_size=group_size, quant=quant)
    xg = _groups(x, group_size)
    expert_in, w, row, *fracs = _dispatch(p.router, xg, top_k,
                                          capacity_factor)
    y = _combine(_experts(expert_in, p.w_gate, p.w_in, p.w_out), w, row)
    return _finish(p, x, y.reshape(x.shape), fracs, quant)


def _moe_block_sharded(p: MoeParams, x, *, top_k: int,
                       capacity_factor: float, group_size: int, quant: str):
    """:func:`moe_block` of a DTensor x, expert-parallel, in three
    ``local_map`` blocks; no index op meets DTensor's propagation (its
    ``index_put`` backward fails on the card in torch 2.11).

    * Routing, slots and the buffer run per rank on the rank's own groups
      — the groups carry the batch's mesh dims under the ambient rules, the
      reference's ``("batch", None, None)`` —: the capacity is a group's,
      so this is the reference's function.  The rows split evenly over the
      batch ranks and each rank's rows whole groups, or else (a decode
      step's one group spans the batch; fewer rows than batch ranks, as a
      microbatch of one row) the tokens are gathered over the batch dims
      first: a token's slot counts the earlier tokens of its whole group,
      whichever rank holds them, every rank routes every group, and no
      rank routes none.
    * The buffer (E, G*C, d) is placed ``("tp", "batch", None)``: the
      reference's ``("batch", "tp", None, None)`` in expert-major order.
      Each ``model`` rank computes its E/tp experts' products only, the
      experts' weights gathered over ``fsdp``'s dims and never over
      ``model``.
    * The combine needs every expert's output for the rank's tokens: the
      outputs are **all-gathered over ``model``** (backward: each rank keeps
      its experts' slice of the gradient).  Then each token sums its k
      products in one product, in the one-process order; a partial sum of
      each rank's experts, reduced over ``model``, would move fewer bytes
      but add the k products in another order.
    * The balance term's two means are each reduced over the batch's mesh
      dims (an all-reduce of two E-vectors) before their product: the
      means of every group, not a mean of per-rank terms.

    At world 1 every redistribution is local and each block runs the
    mesh-less ops on the whole tensors: the same bits."""
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    b, s, d = x.shape
    gs = group_of(b * s, group_size)
    n_groups = b * s // gs
    batch = split_rows = [i for i, pl in enumerate(
        rules_placements(("batch", None, None), x)) if pl == Shard(0)]
    n_split = math.prod(mesh.size(i) for i in batch)
    if b % n_split or n_groups % n_split:  # not whole groups a rank
        batch, n_split = [], 1
    experts = [i for i, pl in enumerate(p.w_gate.placements)
               if pl == Shard(0)]
    if set(experts) & set(batch):
        raise ValueError("moe_block: the experts and the batch share a "
                         "mesh dim")

    def on(dims, pl):
        return [pl if i in dims else Replicate() for i in range(mesh.ndim)]

    rows, fracs = on(batch, Shard(0)), on(batch, Partial())
    buf = on(batch, Shard(1))
    buf_ep = [Shard(0) if i in experts else pl for i, pl in enumerate(buf)]
    w_pl = on(experts, Shard(0))
    whole = [Replicate()] * mesh.ndim

    def dispatch(x_loc, router):
        xg = x_loc.reshape(-1, gs, d)
        expert_in, w, row, ft, fp = _dispatch(router, xg, top_k,
                                              capacity_factor)
        if n_split > 1:  # this rank's share of the means over all groups
            ft, fp = ft / n_split, fp / n_split
        return expert_in, w, row, ft, fp

    expert_in, w, row, ft, fp = local_map(
        dispatch, out_placements=(buf, rows, rows, fracs, fracs),
        in_placements=(rows, whole),
        in_grad_placements=(rows, grad_placements(whole, buf, rows)),
        device_mesh=mesh, redistribute_inputs=True)(x, p.router)
    products = local_map(
        _experts, out_placements=buf_ep,
        in_placements=(buf_ep, w_pl, w_pl, w_pl),
        in_grad_placements=(buf_ep, *[grad_placements(w_pl, buf_ep)] * 3),
        device_mesh=mesh, redistribute_inputs=True)
    expert_out = products(expert_in.redistribute(mesh, buf_ep), p.w_gate,
                          p.w_in, p.w_out).redistribute(mesh, buf)
    y = local_map(
        lambda out, w_loc, row_loc: _combine(out, w_loc, row_loc).reshape(
            -1, s, d),
        out_placements=rows, in_placements=(buf, rows, rows),
        device_mesh=mesh)(expert_out, w, row)
    y = y.redistribute(mesh, on(split_rows, Shard(0)))
    ft, fp = (t.redistribute(mesh, whole) for t in (ft, fp))
    return _finish(p, x, y, (ft, fp), quant)

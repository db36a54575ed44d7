"""Plain PyTorch versions for the flash-attention kernel (B6).

* :func:`ref_attention` — the naive full-softmax GQA oracle, a copy of
  ``repro.kernels.flash_attn.ref.ref_attention``.
* :func:`flash_attention_plain` — B6's plain version: the kernel's own
  order of operations (``src/repro/kernels/flash_attn/kernel.py`` ``_kernel``)
  over kv blocks of ``block_k``.  Scores are f32 (exact products of the
  inputs, f32 sums) times ``1/sqrt(dh)``; masked entries get ``NEG_INF``;
  then the running max, ``exp``, ``p`` rounded to ``v``'s dtype for the PV
  product, an f32 accumulator, and ``acc / max(l, 1e-30)`` at the end, cast
  to q's dtype.  A kv block that the causal or window rule masks for every
  row of a q block is skipped for that q block, as on the TPU.  The CPU
  runs it for the kernel's wrapper; on the card it is what the kernel is
  held against.
* :func:`flash_attention_bwd_plain` — B6-bwd's plain version: dQ, dK and
  dV from the forward's per-row log-sum-exp, in the backward kernel's
  order (``csrc/flash_attn_bwd.cu``).
* :func:`bf16_ulps` — the measure that holds a bf16 output against the
  plain version's, element by element.
* :func:`plain_scores` / :func:`scores_bound` — the plain version's scaled
  scores and the most two f32 summation orders of them can differ by,
  which hold the scores a bf16 kernel reports (below).

Holding a kernel that sums ``q k^T`` in another order than the plain
version's (the Hopper kernel's tensor cores): a score one f32 ulp off can
round its ``p`` to the neighbouring bf16 value, which moves an output
element of small magnitude by several of its own ulps.  So the check holds
the kernel's scores within :func:`scores_bound` of the plain version's,
and its output element by element against the plain version run on those
scores (``scores=``), which repeats every other operation.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
# Below this magnitude an element's ulp is taken at this magnitude: f32 sums
# that cancel to about 0 may differ by more than the ulp of their result.
BF16_FLOOR = 2.0 ** -10


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, Hq, dh); k/v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kk = torch.repeat_interleave(k, g, dim=2)
    vv = torch.repeat_interleave(v, g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) / math.sqrt(dh)
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos[None] <= qpos[:, None]
    if window:
        keep &= kpos[None] > qpos[:, None] - window
    s = torch.where(keep[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return out.to(q.dtype)


def block_runs(q_lo: int, block_q: int, k_lo: int, block_k: int, *,
               causal: bool, window: int) -> bool:
    """Whether kv block ``[k_lo, k_lo + block_k)`` has any unmasked pair
    for q block ``[q_lo, q_lo + block_q)`` (``kernel.py:47-52``)."""
    run = True
    if causal:
        run = k_lo <= q_lo + block_q - 1
    if window:
        run = run and k_lo + block_k - 1 > q_lo - window
    return run


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          block_q: int = 64, block_k: int = 64,
                          group: int = 1, kv_len: int | None = None,
                          scores=None, return_lse: bool = False):
    """q: (BH, Sq, dh); k/v: (BH // group, Sk, dh), Sq and Sk multiples of
    ``block_q`` / ``block_k``; ``kv_len`` the true kv length (default Sk).
    ``scores``: (BH, Sq, Sk) float32 scaled scores to take in place of the
    plain version's own ``q k^T / sqrt(dh)`` (a kernel's, see above); the
    masks still apply.  Returns (BH, Sq, dh) in q's dtype, and with
    ``return_lse`` also each row's log-sum-exp, (BH, Sq) float32: ``m +
    log(max(l, 1e-30))`` of the final running max and sum, -1e30 for a row
    of no kept key (f32 cannot hold -1e30 + log(l))."""
    bh, sq, dh = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    if bh != bkv * group or sq % block_q or sk % block_k:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, group "
                         f"{group}, blocks ({block_q}, {block_k})")
    seq_len = sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    # q head bh reads kv head bh // group: rows (group, Sq) per kv head
    qf = q.reshape(bkv, group * sq, dh).float()
    q_pos = torch.arange(sq, device=dev).repeat(group)        # (group*Sq,)
    q_blk = q_pos // block_q
    m = torch.full((bkv, group * sq, 1), NEG_INF, device=dev)
    l = torch.zeros((bkv, group * sq, 1), device=dev)
    acc = torch.zeros((bkv, group * sq, dh), device=dev)
    if scores is not None:
        scores = scores.reshape(bkv, group * sq, sk)
    for ik in range(sk // block_k):
        k_lo = ik * block_k
        runs = torch.tensor([block_runs(iq * block_q, block_q, k_lo, block_k,
                                        causal=causal, window=window)
                             for iq in range(sq // block_q)], device=dev)
        run = runs[q_blk][None, :, None]                     # (1, rows, 1)
        kb = k[:, k_lo:k_lo + block_k].float()
        vb = v[:, k_lo:k_lo + block_k]
        if scores is None:
            s = torch.matmul(qf, kb.transpose(1, 2)) * scale  # (bkv, rows, Bk)
        else:
            s = scores[:, :, k_lo:k_lo + block_k]
        k_pos = k_lo + torch.arange(block_k, device=dev)
        keep = k_pos[None, :] < seq_len
        if causal:
            keep = keep & (k_pos[None, :] <= q_pos[:, None])
        if window:
            keep = keep & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(keep[None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
        acc_new = acc * corr + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = torch.where(run, m_new, m)
        l = torch.where(run, l_new, l)
        acc = torch.where(run, acc_new, acc)
    out = acc / torch.clamp(l, min=1e-30)
    out = out.reshape(bh, sq, dh).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(torch.clamp(l, min=1e-30))).reshape(bh, sq)


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal: bool = True,
                              window: int = 0, group: int = 1,
                              kv_len: int | None = None):
    """B6-bwd's plain version: (dq, dk, dv) of the forward ``out`` from
    q, out, dout (BH, Sq, dh), k, v (BH // group, Sk, dh) and the forward's
    ``lse`` (BH, Sq) float32, in the kernel's formulas and order
    (``csrc/flash_attn_bwd.cu``): scores ``q k^T`` as f32 sums of the
    inputs' products times ``1/sqrt(dh)``; ``P = exp(s - lse)``, 0 where the
    masks drop the pair (and on every key of a row of no kept key);
    ``D = rowsum(dout * out)``; ``dP = dout v^T``; ``dS = P (dP - D)``;
    ``dV = P^T dout`` with P rounded to v's dtype, ``dQ = (dS k) scale``
    and ``dK = (dS^T q) scale`` with dS rounded to q's dtype, every product
    summed in f32; dK and dV sum over the ``group`` query heads of each kv
    head.  Returns them in the inputs' dtypes.  Fully masked kv tiles, which
    the kernel skips, add exact zeros here."""
    bh, sq, dh = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    if bh != bkv * group or v.shape != k.shape or out.shape != q.shape \
            or dout.shape != q.shape or lse.shape != (bh, sq):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)}, "
                         f"group {group}")
    seq_len = sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    rows = group * sq  # q head bh reads kv head bh // group
    qf = q.reshape(bkv, rows, dh).float()
    dof = dout.reshape(bkv, rows, dh).float()
    q_pos = torch.arange(sq, device=dev).repeat(group)
    k_pos = torch.arange(sk, device=dev)
    keep = (k_pos[None, :] < seq_len).expand(rows, sk)
    if causal:
        keep = keep & (k_pos[None, :] <= q_pos[:, None])
    if window:
        keep = keep & (k_pos[None, :] > q_pos[:, None] - window)
    s = torch.matmul(qf, k.float().transpose(1, 2)) * scale
    p = torch.where(keep[None], torch.exp(s - lse.reshape(bkv, rows, 1)), 0.0)
    d = torch.sum(dof * out.reshape(bkv, rows, dh).float(), dim=-1,
                  keepdim=True)
    dp = torch.matmul(dof, v.float().transpose(1, 2))
    ds = (p * (dp - d)).to(q.dtype).float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(1, 2), dof)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(1, 2), qf) * scale
    return (dq.reshape(bh, sq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bf16_ulps(got, want) -> torch.Tensor:
    """``|got - want|`` element by element, in bf16 ulps at the larger of the
    two magnitudes (at least :data:`BF16_FLOOR`), as float64.

    The kernel and its plain version round at the same places and sum in
    other orders, so an element differs only where its f32 value lies
    within a few f32 ulps of a bf16 rounding boundary: by one ulp, in a few
    elements per million.  A fault of the order of operations (p not
    rounded, a bf16 accumulator) moves most elements, and many by several
    ulps."""
    g, w = got.double(), want.double()
    mag = torch.maximum(torch.maximum(g.abs(), w.abs()),
                        torch.tensor(BF16_FLOOR, dtype=torch.float64,
                                     device=g.device))
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def plain_scores(q, k, *, group: int = 1):
    """The plain version's scaled scores ``q k^T / sqrt(dh)`` (f32 products
    and sums) in the kernel layout: (BH, Sq, Sk) float32."""
    bh, sq, dh = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    qf = q.reshape(bkv, group * sq, dh).float()
    s = torch.matmul(qf, k.float().transpose(1, 2)) * (1.0 / math.sqrt(dh))
    return s.reshape(bh, sq, sk)


def scores_bound(q, k, *, group: int = 1):
    """The most two f32 summation orders of ``q k^T / sqrt(dh)`` can differ
    by, element by element: each order's error is at most ``dh * u`` times
    the sum of the products' magnitudes (u = 2^-24, the products of bf16
    inputs exact), and the scaling rounds once more; twice that, for an
    adder that truncates.  (BH, Sq, Sk) float32."""
    bh, sq, dh = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    qa = q.reshape(bkv, group * sq, dh).float().abs()
    mag = torch.matmul(qa, k.float().abs().transpose(1, 2)) * (
        1.0 / math.sqrt(dh))
    return (mag * (4 * (dh + 1) * 2.0 ** -24)).reshape(bh, sq, sk)


def bwd_bounds(q, k, v, out, dout, lse, *, causal: bool = True,
               window: int = 0, group: int = 1, kv_len: int | None = None):
    """How far B6-bwd's (dq, dk, dv) may lie from its plain version's on the
    same inputs, element by element, as float32 tensors of their shapes.

    The kernel rounds P and dS to bf16 as the plain version does, but its
    tensor cores sum the scores, dP and the three gradient products in
    other f32 orders: a P or dS one f32 ulp off can round to the
    neighbouring bf16 value, at most 2^-7 of its magnitude, and the two f32
    orders of a sum of n products differ by at most ``4 n u`` of their
    magnitudes (u = 2^-24, as :func:`scores_bound`).  So, for dV the
    rounding share ``2^-7 |P|^T |dout|``; for dQ and dK ``2^-7`` of
    ``|dS| |k|`` and ``|dS|^T |q|`` (times the scale) plus the f32 share,
    ``P (|dout| |v|^T + |D|)`` times ``4 (dh + Sk + 1) u`` carried through
    the same products.  :func:`bwd_ratio` adds one bf16 ulp of each
    output's own magnitude, for its final rounding."""
    bh, sq, dh = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    seq_len = sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    rows = group * sq
    qf = q.reshape(bkv, rows, dh).float()
    dof = dout.reshape(bkv, rows, dh).float()
    q_pos = torch.arange(sq, device=dev).repeat(group)
    k_pos = torch.arange(sk, device=dev)
    keep = (k_pos[None, :] < seq_len).expand(rows, sk)
    if causal:
        keep = keep & (k_pos[None, :] <= q_pos[:, None])
    if window:
        keep = keep & (k_pos[None, :] > q_pos[:, None] - window)
    s = torch.matmul(qf, k.float().transpose(1, 2)) * scale
    p = torch.where(keep[None], torch.exp(s - lse.reshape(bkv, rows, 1)), 0.0)
    d = torch.sum(dof * out.reshape(bkv, rows, dh).float(), dim=-1,
                  keepdim=True)
    dp = torch.matmul(dof, v.float().transpose(1, 2))
    ds = (p * (dp - d)).abs()
    f32 = 4 * (dh + sk + 1) * 2.0 ** -24
    ds_f32 = p * (torch.matmul(dof.abs(), v.float().abs().transpose(1, 2))
                  + d.abs()) * f32
    ka, qa = k.float().abs(), qf.abs()
    rnd = 2.0 ** -7
    tv = torch.matmul(p.transpose(1, 2), dof.abs()) * (rnd + f32)
    tq = torch.matmul(rnd * ds + ds_f32, ka) * scale
    tk = torch.matmul((rnd * ds + ds_f32).transpose(1, 2), qa) * scale
    return tq.reshape(bh, sq, dh), tk, tv


def bwd_ratio(got, want, bound) -> torch.Tensor:
    """``|got - want|`` over ``bound`` (:func:`bwd_bounds`) plus one bf16
    ulp of ``want``'s magnitude (at least :data:`BF16_FLOOR` times the
    largest), element by element, as float64: at most 1 where the kernel
    holds."""
    g, w = got.double(), want.double()
    floor = max(float(w.abs().max()) * BF16_FLOOR, 2.0 ** -126)
    mag = torch.clamp(w.abs(), min=floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (g - w).abs() / (bound.double() + ulp)

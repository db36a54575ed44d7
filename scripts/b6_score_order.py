#!/usr/bin/env python3
"""Why B6's bf16 kernel is held against its plain version in two parts
(``chip_smoke.hold_b6_bf16``): how far outputs move when only the order of
summation of q k^T changes, on one H100.

    python3 scripts/b6_score_order.py     # from the repository root

At B 1, 8 query heads, 1 kv head, S 2,048, causal, dh 64 and 128, bf16,
four comparisons, each read as ``ref.bf16_ulps`` (max) and the share of
elements not bit-equal:

* kernel vs plain — the kernel held directly against the plain version;
* plain vs f64 — the plain version against an f64 emulation of itself
  (the same blocks and p rounded to bf16, every other operation in f64):
  another order of the same sums, no kernel involved;
* kernel vs f64 — the kernel against the same emulation;
* each of the three again with q and k on multiples of 1/8, where q k^T is
  exact in f32 in any order.

Prints one JSON line a reading and the card's name and power limit.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def plain_f64(q, k, v, *, causal, window, block_q, block_k, group, kv_len):
    """``ref.flash_attention_plain`` in f64, p still rounded to bf16."""
    from repro_torch.kernels.flash_attn.ref import NEG_INF, block_runs

    bh, sq, dh = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    dev, f64 = q.device, torch.float64
    qf = q.reshape(bkv, group * sq, dh).to(f64)
    q_pos = torch.arange(sq, device=dev).repeat(group)
    q_blk = q_pos // block_q
    m = torch.full((bkv, group * sq, 1), NEG_INF, device=dev, dtype=f64)
    l = torch.zeros_like(m)
    acc = torch.zeros((bkv, group * sq, dh), device=dev, dtype=f64)
    for k_lo in range(0, sk, block_k):
        runs = torch.tensor([block_runs(iq * block_q, block_q, k_lo, block_k,
                                        causal=causal, window=window)
                             for iq in range(sq // block_q)], device=dev)
        run = runs[q_blk][None, :, None]
        s = torch.matmul(qf, k[:, k_lo:k_lo + block_k].to(f64).transpose(
            1, 2)) / math.sqrt(dh)
        k_pos = k_lo + torch.arange(block_k, device=dev)
        keep = k_pos[None, :] < kv_len
        if causal:
            keep = keep & (k_pos[None, :] <= q_pos[:, None])
        if window:
            keep = keep & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(keep[None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        pv = torch.matmul(p.to(torch.bfloat16).to(f64),
                          v[:, k_lo:k_lo + block_k].to(f64))
        m = torch.where(run, m_new, m)
        l = torch.where(run, l * corr + p.sum(-1, keepdim=True), l)
        acc = torch.where(run, acc * corr + pv, acc)
    return (acc / l.clamp(min=1e-30)).reshape(bh, sq, dh).to(torch.bfloat16)


def main() -> int:
    if not torch.cuda.is_available():
        print("b6_score_order: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.common import disable_tf32
    from repro_torch.kernels.flash_attn import kernel, ref
    from repro_torch.kernels.flash_attn.ops import kernel_layout

    disable_tf32()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(5)
    for dh in (64, 128):
        for grid in (False, True):
            q, k, v = (torch.randn((1, 2048, h, dh), generator=gen,
                                   device=device) for h in (8, 1, 1))
            if grid:
                q, k = (torch.round(x * 8) / 8 for x in (q, k))
            q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
            qf, kf, vf, kw = kernel_layout(q, k, v, causal=True)
            got = kernel.flash_attention_call(qf, kf, vf, **kw)
            plain = ref.flash_attention_plain(qf, kf, vf, **kw)
            f64 = plain_f64(qf, kf, vf, **kw)
            for what, a, b in (("kernel vs plain", got, plain),
                               ("plain vs f64", plain, f64),
                               ("kernel vs f64", got, f64)):
                print(json.dumps({
                    "dh": dh, "qk": "grid of 1/8" if grid else "normal",
                    "what": what,
                    "max_ulps": float(ref.bf16_ulps(a, b).max()),
                    "share_differ": float((a != b).float().mean())}),
                    flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

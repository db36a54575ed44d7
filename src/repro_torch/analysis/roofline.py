"""Roofline-term arithmetic (counterpart of ``repro.analysis.roofline``):

    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes / device-memory bytes/s
    collective term = collective bytes / NVLink bytes/s

per device, with the H100's published peaks in place of the TPU v5e's.
``H100`` is the one definition of those peaks in the port: ``chip_smoke.py``
prices its kernels' bounds with it and ``core.fpga_cost_model`` prices the
paper's training workload.

Hardware constants (NVIDIA H100 SXM data sheet, dense rates without
sparsity, at the full 700 W power limit): 989 TFLOP/s bf16 and 1,979 TOP/s
int8 on the tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of
HBM3 (80 GB), 132 SMs, NVLink 4 at 900 GB/s a card both ways (450 GB/s
each way).  A card set below 700 W runs below these peaks.
"""

from __future__ import annotations

H100 = {
    "peak_bf16_flops": 989e12,
    "peak_int8_ops": 1979e12,
    "peak_fp32_flops": 67e12,    # fp32 outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
    "nvlink_bytes_per_s": 450e9,  # each way, one card
    "hbm_bytes": 80e9,
    "n_sms": 132,
}


def roofline_terms(*, flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, chips: int,
                   model_flops_total: float = 0.0,
                   int8_fraction: float = 0.0) -> dict:
    """All terms in seconds (per step, per device).

    ``int8_fraction``: the share of the FLOPs on the int8 tensor cores
    (twice the bf16 rate) when the paper's QAT technique is active; each
    share runs at its own peak, so the times add.
    """
    t_compute = (flops_per_device * (1 - int8_fraction)
                 / H100["peak_bf16_flops"]
                 + flops_per_device * int8_fraction / H100["peak_int8_ops"])
    t_memory = bytes_per_device / H100["hbm_bytes_per_s"]
    t_coll = collective_bytes_per_device / H100["nvlink_bytes_per_s"]
    terms = {"t_compute_s": t_compute, "t_memory_s": t_memory,
             "t_collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    t_bound = terms[dominant]
    useful = (model_flops_total / chips / max(flops_per_device, 1.0)
              if model_flops_total else None)
    return {
        **terms,
        "dominant": dominant.replace("t_", "").replace("_s", ""),
        "t_bound_s": t_bound,
        # the share of the roofline reached if the terms overlap perfectly
        "roofline_fraction": t_compute / max(t_bound, 1e-30),
        "useful_flops_ratio": useful,
        "chips": chips,
    }


def model_flops_train(n_params_active: int, n_tokens: int) -> float:
    """MODEL_FLOPS = 6 * N * D (dense) / 6 * N_active * D (MoE)."""
    return 6.0 * n_params_active * n_tokens


def model_flops_decode(n_params_active: int, n_tokens: int) -> float:
    """Decode: 2 * N_active a token (the forward's products only)."""
    return 2.0 * n_params_active * n_tokens


def ssd_flops(cfg, batch: int, seq: int) -> float:
    """The f32 products of the SSD scan (``models.ssm.ssd_chunked``) over
    every layer of an SSM or hybrid ``cfg``, for ``batch`` sequences of
    ``seq`` tokens padded to chunks of ``min(ssm_chunk, seq)``: within a
    chunk C B^T and its decay-weighted product with x on the causal
    triangle (the pairs the scan needs), each chunk's end state
    (B x_dt outer products) and the carried state's outputs (C . state).
    ``seq`` 1 prices a decode step.  0 for the other families."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    q = min(cfg.ssm_chunk, seq)
    chunks = -(-seq // q)
    h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    pairs = q * (q + 1) // 2
    per_chunk = 2 * pairs * n + 2 * pairs * h * p + 2 * 2 * q * h * p * n
    return float(cfg.n_layers * batch * chunks * per_chunk)

"""Cycle model of the paper's FPGA training design, and what the same
training workload costs on one H100 (counterpart of
``repro.core.fpga_cost_model``).

Paper facts modelled (Results §3):
* one generic node block: 16 nodes semi-parallel, 4 cycles per block step;
  forward across all layers of the adapted net = 56 cycles;
* one backprop block (16x32 weight tile), 3 cycles per step; full backward
  pass = 104 cycles;
* f_clk = 200 MHz (250 MHz feasible), 250M training samples
  -> Eq. (3): 5ns * 250e6 * (56 + 104) = 200 s;
* resources: NN+backprop 145k LUT / 5k DSP / 146k FF (8% LUT, 40% DSP of the
  ALVEO U250); PCIe adds 83k LUT / 148k FF / 150 BRAM;
* CPU baseline: ~16 h on a Ryzen 9 3900 -> the paper's "up to 250x" claim.

The FPGA side is the reference's arithmetic, unchanged.  The reference's
TPU side is replaced by the H100 side: the operations and bytes of the
port's fused training kernel (B1-B3, ``csrc/fused_train.cu``) at the net's
true widths, priced at the card's fp32 rate outside the tensor cores
(the kernel keeps IEEE fp32 and no tensor cores) — the whole card's, or
``cluster``/132 of it for the one thread-block cluster of ``cluster`` SMs
that runs a launch — and its device-memory rate (``analysis.roofline.H100``).

The paper's algorithm is the per-sample stream: one SGD update a sample
(tile 1).  A minibatch update a tile of 128 samples is a different
algorithm (beyond the paper); every price here names the algorithm it is
for (:func:`train_algorithm`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.analysis.roofline import H100

# ---------------------------------------------------------------------------
# FPGA side (the reference's, unchanged)
# ---------------------------------------------------------------------------

U250_RESOURCES = {"LUT": 1_728_000, "FF": 3_456_000, "DSP": 12_288,
                  "BRAM": 2_688}

PAPER = {
    "fwd_cycles": 56,
    "bwd_cycles": 104,
    "cycles_per_sample": 160,
    "clock_hz": 200e6,
    "n_train_samples": 250_000_000,
    "train_seconds": 200.0,
    "cpu_train_seconds": 16 * 3600.0,  # ~16 h on Ryzen 9 3900
    "resources_nn": {"LUT": 145_000, "DSP": 5_000, "FF": 146_000},
    "resources_pcie": {"LUT": 83_000, "FF": 148_000, "BRAM": 150},
}


@dataclasses.dataclass(frozen=True)
class FpgaDesign:
    clock_hz: float = 200e6
    node_block: int = 16          # nodes computed in parallel
    fwd_cycles_per_block: int = 4
    bwd_tile: tuple = (32, 16)    # backprop weight tile (in, out)
    bwd_cycles_per_tile: int = 3  # weight/bias update sweep
    delta_cycles_per_tile: int = 2  # delta back-propagation sweep


def fwd_cycles(widths: Sequence[int], d: FpgaDesign = FpgaDesign()) -> int:
    """Forward cycles: the node block is time-multiplexed over every layer's
    output nodes.  widths = (in, h1, ..., out)."""
    outs = widths[1:]
    return d.fwd_cycles_per_block * sum(math.ceil(n / d.node_block)
                                        for n in outs)


def bwd_cycles(widths: Sequence[int], d: FpgaDesign = FpgaDesign()) -> int:
    """Backward cycles (Eq. 2): a weight/bias-update sweep of the 32x16
    block a transition (3 cycles a tile) and a delta-propagation sweep (2
    cycles a tile; none into the input layer).  On the adapted net
    3*24 + 2*16 = 104, the paper's stated count."""
    ti, to = d.bwd_tile
    upd_tiles, delta_tiles = 0, 0
    for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
        tiles = math.ceil(n_in / ti) * math.ceil(n_out / to)
        upd_tiles += tiles
        if i > 0:  # no delta propagated into the input layer
            delta_tiles += tiles
    return (d.bwd_cycles_per_tile * upd_tiles
            + d.delta_cycles_per_tile * delta_tiles)


def train_seconds(widths: Sequence[int], n_samples: int,
                  d: FpgaDesign = FpgaDesign()) -> float:
    """Eq. (3) generalised: period * samples * (fwd + bwd) cycles."""
    c = fwd_cycles(widths, d) + bwd_cycles(widths, d)
    return (1.0 / d.clock_hz) * n_samples * c


def paper_eq3_seconds() -> float:
    """The paper's own arithmetic, exactly."""
    return ((1.0 / PAPER["clock_hz"]) * PAPER["n_train_samples"]
            * PAPER["cycles_per_sample"])


def resource_estimate(widths: Sequence[int],
                      d: FpgaDesign = FpgaDesign()) -> dict:
    """Analytic resource model calibrated to the paper's totals: a node
    unit ~ (4,200 LUT, 170 DSP) with control, a backprop lane ~ (2,400 LUT,
    70 DSP), int8 weights in FF/LUTRAM."""
    params = sum(i * o + o for i, o in zip(widths[:-1], widths[1:]))
    node_lut, node_dsp = 4_200, 170
    bp_lut_per_lane, bp_dsp_per_lane = 2_400, 70
    lanes = d.bwd_tile[1]
    lut = d.node_block * node_lut + lanes * bp_lut_per_lane + 12_000
    dsp = d.node_block * node_dsp + lanes * bp_dsp_per_lane
    ff = params * 8 + 25_000
    return {
        "LUT": lut, "DSP": dsp, "FF": ff,
        "LUT_frac": lut / U250_RESOURCES["LUT"],
        "DSP_frac": dsp / U250_RESOURCES["DSP"],
        "params": params,
    }


def train_flops_per_sample(widths: Sequence[int]) -> int:
    """The reference's rule of thumb: fwd (2*MACs) + bwd (~2x fwd)."""
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    return 2 * macs * 3


# ---------------------------------------------------------------------------
# H100 side: the port's fused training kernel at the true widths
# ---------------------------------------------------------------------------

UPDATE_FLOPS = {"sgd": 2, "adam": 16}  # a parameter, a tile


def train_algorithm(tile: int) -> str:
    """The name of the training algorithm a tile of ``tile`` samples runs."""
    if tile == 1:
        return "per-sample stream (the paper's algorithm)"
    return f"minibatch at tile {tile} (beyond the paper)"


def _n_params(widths: Sequence[int]) -> int:
    return sum(i * o + o for i, o in zip(widths[:-1], widths[1:]))


def kernel_train_ops(widths: Sequence[int], n_rows: int, tile: int,
                     optimizer: str = "sgd") -> int:
    """The operations of training over ``n_rows`` samples in tiles of
    ``tile``: the forward, dW and dh products (2 FLOP a multiply-add each;
    no dh into the input layer; 59,584 FLOP a sample on mrf-fpga), plus
    the update of every parameter once a tile."""
    pairs = list(zip(widths[:-1], widths[1:]))
    macs = sum(k * m for k, m in pairs)
    dh_macs = sum(k * m for k, m in pairs[1:])
    per_sample = 2 * macs + 2 * macs + 2 * dh_macs
    return (n_rows * per_sample
            + (n_rows // tile) * _n_params(widths) * UPDATE_FLOPS[optimizer])


def kernel_train_bytes(widths: Sequence[int], n_rows: int, tile: int,
                       optimizer: str = "sgd") -> int:
    """The bytes of one launch over ``n_rows`` samples: x and y read once,
    the net read and written once (Adam's two moments too, and its step),
    a loss a tile written; all fp32."""
    n = _n_params(widths)
    floats = (n_rows * (widths[0] + widths[-1]) + 2 * n
              + (4 * n + 1 if optimizer == "adam" else 0) + n_rows // tile)
    return 4 * floats


def h100_train_seconds(widths: Sequence[int], n_samples: int, *, tile: int,
                       cluster: int, optimizer: str = "sgd") -> dict:
    """The least time the fused kernel could train ``n_samples`` in tiles
    of ``tile`` on one cluster of ``cluster`` SMs: its operations at
    ``cluster``/132 of the fp32 rate against its bytes at the device-memory
    rate.  The reference's TPU estimate priced 128-lane padded layers on the
    int8 MXU; this prices the true widths in fp32, as the kernel runs."""
    ops = kernel_train_ops(widths, n_samples, tile, optimizer)
    nbytes = kernel_train_bytes(widths, n_samples, tile, optimizer)
    t_compute = ops / (H100["peak_fp32_flops"] * cluster / H100["n_sms"])
    t_memory = nbytes / H100["hbm_bytes_per_s"]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_total_s": max(t_compute, t_memory),
        "bound": "memory" if t_memory > t_compute else "compute",
        "ops": ops,
        "bytes": nbytes,
        "tile": tile,
        "cluster": cluster,
        "algorithm": train_algorithm(tile),
    }

"""The chip's peaks and the work of MRF training, frozen for the benchmark.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W power
limit; float32 outside the tensor cores is the rate of a training step that
keeps IEEE float32 and takes no TF32 (the MRF configurations state so).

Work: training an MLP of ``widths`` = (in, hidden..., out) over ``rows``
samples in tiles of ``tile`` samples, one optimizer update a tile.
Operations are the forward, dW and dh products at the true widths (2 FLOP
a multiply-add; no dh into the input layer), plus the update of every
parameter once a tile (SGD 2 FLOP a parameter, Adam 16).  Bytes are what a
launch must move at the least: its rows of x and y read once, the net
read and written once (Adam's two moments too, and its step counter), one
loss a tile written, all float32; a window of ``launches`` launches pays
the net's traffic once a launch.  The count is the same whatever computes
the step, so a roofline share read against it stays comparable across
implementations.
"""

from __future__ import annotations

from typing import Sequence

H100 = {
    "peak_fp32_flops": 67e12,   # float32 outside the tensor cores, 132 SMs
    "peak_bf16_flops": 989e12,  # dense, on the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}

UPDATE_FLOPS = {"sgd": 2, "adam": 16}  # a parameter, a tile


def n_params(widths: Sequence[int]) -> int:
    return sum(k * n + n for k, n in zip(widths[:-1], widths[1:]))


def flops_per_sample(widths: Sequence[int]) -> int:
    """Forward, dW and dh products of one sample: 59,584 FLOP on
    mrf-fpga, 223,424 on mrf-original."""
    pairs = list(zip(widths[:-1], widths[1:]))
    macs = sum(k * n for k, n in pairs)
    dh_macs = sum(k * n for k, n in pairs[1:])
    return 2 * macs + 2 * macs + 2 * dh_macs


def train_ops(widths: Sequence[int], rows: int, tile: int,
              optimizer: str) -> int:
    if rows % tile:
        raise ValueError(f"{rows} rows are not whole tiles of {tile}")
    return (rows * flops_per_sample(widths)
            + (rows // tile) * n_params(widths) * UPDATE_FLOPS[optimizer])


def train_bytes(widths: Sequence[int], rows: int, tile: int, optimizer: str,
                launches: int = 1) -> int:
    if rows % tile:
        raise ValueError(f"{rows} rows are not whole tiles of {tile}")
    n = n_params(widths)
    per_launch = 2 * n + (4 * n + 1 if optimizer == "adam" else 0)
    floats = (rows * (widths[0] + widths[-1]) + launches * per_launch
              + rows // tile)
    return 4 * floats


def least_seconds(ops: float, nbytes: float) -> tuple:
    """(least seconds, the bound that sets it) on the whole chip: the
    operations at the float32 peak of all 132 SMs against the bytes at the
    HBM rate."""
    t_ops = ops / H100["peak_fp32_flops"]
    t_bytes = nbytes / H100["hbm_bytes_per_s"]
    return (t_ops, "compute") if t_ops >= t_bytes else (t_bytes, "memory")

"""The work of a Mamba-2 LM training step and of its SSD scan, frozen for
the benchmark (from the port's ``analysis.roofline.ssd_flops`` and
``chip_smoke.lm_step_work``).  ``m`` is a configuration file's widths
(``configs/<name>.json``): ``n_layers``, ``d_model``, ``d_inner``,
``n_heads``, ``head_dim``, ``d_state``, ``chunk_size``, ``vocab_rows``.
Peaks are ``yardstick.work.H100``'s.

* The scan's products (:func:`ssd_flops`), over every layer for ``batch``
  sequences of ``seq`` tokens in chunks of ``chunk_size``: within a chunk
  C B^T and its decay-weighted product with x on the causal triangle (the
  pairs the scan needs), each chunk's end state (B x_dt outer products)
  and the carried state's outputs (C . state); 2 FLOP a multiply-add.
* The scan's least work in a step (:func:`scan_ops`, :func:`scan_bytes`):
  those products forward and twice in the backward, and its inputs (x, dt,
  A, B, C) and outputs (y, the final state) read or written once in the
  forward, the output's gradient and the inputs again read and the inputs'
  gradients written once in the backward, all float32.  What recomputes
  the scan or how its kernels split the work is left out, so that one count
  holds for any implementation of the scan.
* The step's model FLOP (:func:`model_flops`): the forward's products, 2
  FLOP a parameter a token passes through (the port's per-layer count:
  the projections, norms and per-head vectors; not the conv's taps) and
  the head on every token (the embedding a gather), plus the scan's
  products; three times that for forward and backward.  A recompute is
  not model work.
"""

from __future__ import annotations

from torch_bench.yardstick.work import H100

F32 = 4  # bytes


def ssd_flops(m: dict, batch: int, seq: int) -> int:
    q = min(m["chunk_size"], seq)
    chunks = -(-seq // q)
    h, p, n = m["n_heads"], m["head_dim"], m["d_state"]
    pairs = q * (q + 1) // 2
    per_chunk = 2 * pairs * n + 2 * pairs * h * p + 2 * 2 * q * h * p * n
    return m["n_layers"] * batch * chunks * per_chunk


def scan_ops(m: dict, batch: int, seq: int) -> int:
    return 3 * ssd_flops(m, batch, seq)


def scan_bytes(m: dict, batch: int, seq: int) -> int:
    tokens = batch * seq
    x = tokens * m["d_inner"]
    ins = x + tokens * m["n_heads"] + m["n_heads"] + 2 * tokens * m["d_state"]
    state = batch * m["n_heads"] * m["head_dim"] * m["d_state"]
    forward = ins + x + state
    backward = x + ins + ins
    return m["n_layers"] * F32 * (forward + backward)


def layer_params(m: dict) -> int:
    d, di, h, n = m["d_model"], m["d_inner"], m["n_heads"], m["d_state"]
    return 2 * d + d * (2 * di + 2 * n + h) + di * d + 3 * h + di


def model_flops(m: dict, batch: int, seq: int) -> int:
    tokens = batch * seq
    forward = 2 * tokens * (m["n_layers"] * layer_params(m)
                            + m["d_model"] * m["vocab_rows"])
    return 3 * forward + scan_ops(m, batch, seq)


def scan_least_seconds(m: dict, batch: int, seq: int) -> float:
    """The scan's least time in a step on the whole chip: its products at
    the float32 peak against its bytes at the HBM rate, the larger."""
    return max(scan_ops(m, batch, seq) / H100["peak_fp32_flops"],
               scan_bytes(m, batch, seq) / H100["hbm_bytes_per_s"])

"""Port parity: ``repro_torch.core.fpga_cost_model`` and
``repro_torch.analysis.roofline`` against the JAX package.

* The FPGA side (the paper's cycle model, Eq. 3, the resource model) equals
  the reference's exactly, on the paper's nets and on random widths.
* The H100 side prices the port's fused training kernel: its compute term
  reproduces the bounds ``chip_smoke.py`` recorded for B1 and B2
  (``PERF.md`` §6) to 6 digits, and each price names its algorithm.
* ``roofline_terms`` against hand arithmetic at the H100's peaks.

The reference's allowlisted names (``scripts/dead_exports_allowlist.txt``)
are read with ``getattr``: an identifier would count as a use of them.
"""

import dataclasses

import numpy as np
import pytest

from _hypothesis_fallback import given, settings, strategies as st
from repro.core import fpga_cost_model as jfcm
from repro_torch.analysis import roofline
from repro_torch.core import fpga_cost_model as pfcm
from repro_torch.core import mrf_net

ADAPTED = mrf_net.layer_sizes(32)                                # mrf-fpga
ORIGINAL = mrf_net.layer_sizes(32, mrf_net.ORIGINAL_HIDDEN)     # mrf-original


def _jax_design():
    return getattr(jfcm, "FPGA" + "Design")()


def test_paper_constants_and_eq3():
    assert pfcm.PAPER == jfcm.PAPER
    assert pfcm.U250_RESOURCES == getattr(jfcm, "ALVEO_" + "U250")
    assert dataclasses.asdict(pfcm.FpgaDesign()) == \
        dataclasses.asdict(_jax_design())
    assert pfcm.paper_eq3_seconds() == jfcm.paper_eq3_seconds() == 200.0
    assert (pfcm.fwd_cycles(ADAPTED), pfcm.bwd_cycles(ADAPTED)) == (56, 104)
    assert pfcm.train_seconds(ADAPTED, 250_000_000) == 200.0


@pytest.mark.parametrize("widths", [ADAPTED, ORIGINAL, (8, 2), (300, 17, 2)])
def test_fpga_side_equals_jax_on_named_nets(widths):
    assert pfcm.fwd_cycles(widths) == jfcm.fwd_cycles(widths)
    assert pfcm.bwd_cycles(widths) == jfcm.bwd_cycles(widths)
    assert pfcm.train_seconds(widths, 12_345) == \
        jfcm.train_seconds(widths, 12_345)
    assert pfcm.resource_estimate(widths) == jfcm.resource_estimate(widths)


@settings(max_examples=40, deadline=None)
@given(n_layers=st.integers(1, 9), seed=st.integers(0, 2**16),
       node_block=st.sampled_from([8, 16, 32]),
       clock_mhz=st.sampled_from([200, 250]))
def test_fpga_side_equals_jax_on_random_widths(n_layers, seed, node_block,
                                               clock_mhz):
    widths = tuple(int(w) for w in np.random.default_rng(seed).integers(
        1, 300, n_layers + 1))
    pd = pfcm.FpgaDesign(clock_hz=clock_mhz * 1e6, node_block=node_block)
    jd = dataclasses.replace(_jax_design(), clock_hz=clock_mhz * 1e6,
                             node_block=node_block)
    assert pfcm.fwd_cycles(widths, pd) == jfcm.fwd_cycles(widths, jd)
    assert pfcm.bwd_cycles(widths, pd) == jfcm.bwd_cycles(widths, jd)
    n = int(np.random.default_rng(seed + 1).integers(1, 10**9))
    assert pfcm.train_seconds(widths, n, pd) == \
        jfcm.train_seconds(widths, n, jd)
    assert pfcm.resource_estimate(widths, pd) == \
        jfcm.resource_estimate(widths, jd)
    assert pfcm.train_flops_per_sample(widths) == \
        getattr(jfcm, "mlp_train_" + "flops_per_sample")(widths)


def test_h100_side_reproduces_the_recorded_kernel_bounds():
    """B1 over 1,024 samples at tile 1 on one SM and B2 over 50 x 256 at
    tile 128 on 8 SMs: the bounds of PERF.md §6 (chip_smoke.py's)."""
    assert pfcm.kernel_train_ops(ADAPTED, 1, 1) - 2 * 11_506 == 59_584
    b1 = pfcm.h100_train_seconds(ADAPTED, 1024, tile=1, cluster=1)
    b2 = pfcm.h100_train_seconds(ADAPTED, 12_800, tile=128, cluster=8)
    b3 = pfcm.h100_train_seconds(ADAPTED, 12_800, tile=128, cluster=8,
                                 optimizer="adam")
    assert round(b1["t_compute_s"] * 1e3, 6) == 0.166632
    assert round(b2["t_compute_s"] * 1e3, 6) == 0.188390
    assert round(b3["t_compute_s"] * 1e3, 6) == 0.192357
    # the whole card's rate: the kernel row's bound_ms
    full = pfcm.h100_train_seconds(ADAPTED, 1024, tile=1, cluster=132)
    assert round(full["t_total_s"] * 1e3, 7) == 0.0012624
    assert full["bound"] == "compute"
    assert b1["bytes"] == 4 * (1024 * 66 + 2 * 11_506 + 1024)
    assert b3["bytes"] == 4 * (12_800 * 66 + 6 * 11_506 + 1 + 100)


def test_h100_prices_name_their_algorithm():
    stream = pfcm.h100_train_seconds(ADAPTED, 250_000_000, tile=1, cluster=1)
    batch = pfcm.h100_train_seconds(ADAPTED, 250_000_000, tile=128,
                                    cluster=8)
    assert stream["algorithm"] == "per-sample stream (the paper's algorithm)"
    assert batch["algorithm"] == "minibatch at tile 128 (beyond the paper)"
    assert stream["t_total_s"] == pytest.approx(40.68161194, rel=1e-8)
    assert batch["t_total_s"] == pytest.approx(3.67948653, rel=1e-8)
    assert stream["t_memory_s"] < stream["t_compute_s"]
    with pytest.raises(KeyError):
        pfcm.kernel_train_ops(ADAPTED, 1, 1, optimizer="lamb")


def test_roofline_terms_by_hand():
    h = roofline.H100
    assert (h["peak_bf16_flops"], h["peak_int8_ops"], h["peak_fp32_flops"],
            h["hbm_bytes_per_s"], h["n_sms"]) == (989e12, 1979e12, 67e12,
                                                  3.35e12, 132)
    t = roofline.roofline_terms(
        flops_per_device=989e12, bytes_per_device=6.7e12,
        collective_bytes_per_device=450e9, chips=4,
        model_flops_total=4 * 0.5 * 989e12, int8_fraction=0.5)
    assert t["t_compute_s"] == pytest.approx(0.5 + 0.5 * 989 / 1979)
    assert t["t_memory_s"] == pytest.approx(2.0)
    assert t["t_collective_s"] == pytest.approx(1.0)
    assert (t["dominant"], t["t_bound_s"]) == ("memory", t["t_memory_s"])
    assert t["roofline_fraction"] == pytest.approx(t["t_compute_s"] / 2.0)
    assert t["useful_flops_ratio"] == pytest.approx(0.5)
    assert t["chips"] == 4
    assert roofline.model_flops_train(10, 3) == 180.0
    assert roofline.model_flops_decode(10, 3) == 60.0

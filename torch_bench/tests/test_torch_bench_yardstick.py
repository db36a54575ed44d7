"""The benchmark's yardstick on the CPU: the frozen work counts against hand
counts, the plain reference's SGD and Adam steps against steps computed by
hand, TF32 rounding, and the compared numbers."""

import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from torch_bench.yardstick import compare, reference, work  # noqa: E402

FPGA = (64, 64, 64, 32, 16, 16, 16, 2)
ORIGINAL = (64, 128, 128, 64, 64, 32, 16, 16, 16, 2)


@pytest.mark.parametrize("widths, flops, params", [
    (FPGA, 59_584, 11_506), (ORIGINAL, 223_424, 40_434)])
def test_flops_per_sample_are_the_hand_counts(widths, flops, params):
    # mrf-fpga: products 11,296 multiply-adds, dh 7,200 (none into the
    # input layer): 4 x 11,296 + 2 x 7,200 = 59,584
    assert work.flops_per_sample(widths) == flops
    assert work.n_params(widths) == params


def test_ops_and_bytes_of_a_window():
    ops = work.train_ops(FPGA, 4096, 1, "sgd")
    assert ops == 4096 * (59_584 + 2 * 11_506)
    adam = work.train_ops(ORIGINAL, 65_536, 128, "adam")
    assert adam == 65_536 * 223_424 + 512 * 40_434 * 16
    # rows of x (64) and y (2), the net in and out, a loss a tile; Adam
    # adds its moments in and out and its step
    assert work.train_bytes(FPGA, 4096, 1, "sgd", launches=2) == 4 * (
        4096 * 66 + 2 * 2 * 11_506 + 4096)
    assert work.train_bytes(ORIGINAL, 256, 128, "adam") == 4 * (
        256 * 66 + 2 * 40_434 + 4 * 40_434 + 1 + 2)
    with pytest.raises(ValueError):
        work.train_ops(FPGA, 100, 128, "sgd")


def test_least_seconds_names_its_bound():
    assert work.least_seconds(67e12, 1.0) == (1.0, "compute")
    assert work.least_seconds(1.0, 3.35e12) == (1.0, "memory")


# a 2-2-1 net by hand: W1 (in, out), b1, W2, b2
P0 = [(np.array([[0.5, -0.25], [0.1, 0.2]]), np.array([0.0, 0.1])),
      (np.array([[0.3], [-0.4]]), np.array([0.05]))]


def _by_hand(p, x, y):
    """Loss and the four gradients of the 2-2-1 net at one sample, each
    written out."""
    (w1, b1), (w2, b2) = p
    z = [x[0] * w1[0, j] + x[1] * w1[1, j] + b1[j] for j in range(2)]
    h = [max(v, 0.0) for v in z]
    out = h[0] * w2[0, 0] + h[1] * w2[1, 0] + b2[0]
    d = 2 * (out - y)
    dw2 = np.array([[h[0] * d], [h[1] * d]])
    dh = [d * w2[j, 0] * (1.0 if h[j] > 0 else 0.0) for j in range(2)]
    dw1 = np.array([[x[i] * dh[j] for j in range(2)] for i in range(2)])
    return (out - y) ** 2, [dw1, np.array(dh), dw2, np.array([d])]


def test_reference_sgd_step_by_hand():
    x, y = np.array([[1.0, 2.0]]), np.array([[0.2]])
    got = reference.train(P0, x, y, tile=1, optimizer="sgd", lr=0.1,
                          steps=1)
    # out 0.16, diff -0.04: loss 0.0016; dz -0.08
    assert got["losses"] == [pytest.approx(0.0016, abs=1e-15)]
    want = [np.array([[0.5024, -0.2532], [0.1048, 0.1936]]),
            np.array([0.0024, 0.0968]), np.array([[0.3056], [-0.398]]),
            np.array([0.058])]
    for a, b in zip(got["params"], want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)
    assert got["updates"] == 1


def test_reference_adam_two_updates_by_hand():
    x = np.array([[1.0, 2.0], [0.5, -1.0]])
    y = np.array([[0.2], [0.9]])
    lr, b1, b2, eps = 0.01, 0.9, 0.999, 1e-8
    p = [a.copy() for wb in P0 for a in wb]
    m = [np.zeros_like(a) for a in p]
    v = [np.zeros_like(a) for a in p]
    losses = []
    for t in (1, 2):
        loss, g = _by_hand([(p[0], p[1]), (p[2], p[3])], x[t - 1],
                           y[t - 1, 0])
        losses.append(loss)
        for i in range(4):
            m[i] = b1 * m[i] + (1 - b1) * g[i]
            v[i] = b2 * v[i] + (1 - b2) * g[i] ** 2
            p[i] = p[i] - lr * (m[i] / (1 - b1 ** t)) / (
                np.sqrt(v[i] / (1 - b2 ** t)) + eps)
    got = reference.train(P0, x, y, tile=1, optimizer="adam", lr=lr,
                          steps=2)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-13)
    for a, b in zip(got["params"], p):
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-15)
    # after step 1 Adam's first moment is a tenth of the first gradient
    _, g1 = _by_hand(P0, x[0], y[0, 0])
    for a, b in zip(got["first"], g1):
        np.testing.assert_allclose(a, 0.1 * b, rtol=1e-13, atol=1e-18)


def test_reference_tile_mean_and_half_batch():
    x = np.array([[1.0, 2.0], [0.5, -1.0]])
    y = np.array([[0.2], [0.9]])
    l0, g0 = _by_hand(P0, x[0], y[0, 0])
    l1, g1 = _by_hand(P0, x[1], y[1, 0])
    got = reference.train(P0, x, y, tile=2, optimizer="sgd", lr=0.1,
                          steps=1)
    assert got["losses"][0] == pytest.approx((l0 + l1) / 2, rel=1e-14)
    flat0 = [a for wb in P0 for a in wb]
    for a, p, ga, gb in zip(got["params"], flat0, g0, g1):
        np.testing.assert_allclose(a, p - 0.1 * (ga + gb) / 2, atol=1e-15)
    half = reference.train(P0, x, y, tile=1, optimizer="sgd", lr=0.1,
                           steps=1, fault="half_batch")
    assert half["losses"] == [pytest.approx(l0, rel=1e-14)]
    assert half["updates"] == 1


def test_tf32_rounds_to_ten_mantissa_bits():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    a = np.array([one + ulp / 4, one + ulp * 3 / 4, -(one + ulp / 2),
                  one + ulp], dtype=np.float32)
    np.testing.assert_array_equal(
        reference.tf32(a), np.array([one, one + ulp, -(one + ulp),
                                     one + ulp], dtype=np.float32))


def _seg(losses, start, params):
    return {"losses": losses, "start": start, "params": params}


P_0 = [np.ones((3, 2)), np.zeros(2), np.ones((2, 1)), np.zeros(1)]


def _ref():
    """Segments: step 1, a launch of two steps, two single steps; every
    step moves each element by -0.1."""
    ps = [[a - 0.1 * k for a in P_0] for k in range(6)]
    return {"segments": [_seg([1.0], ps[0], ps[1]),
                         _seg([0.5, 0.25], ps[1], ps[3]),
                         _seg([0.2], ps[3], ps[4]),
                         _seg([0.1], ps[4], ps[5])]}


def _prog(ref, **change):
    """``ref``'s segments as a program's side, with ``change[k]`` applied
    to segment k's parameters."""
    segs = []
    for k, r in enumerate(ref["segments"]):
        params = change[f"s{k}"](r) if f"s{k}" in change else r["params"]
        segs.append(_seg(list(r["losses"]), None, params))
    return {"segments": segs, "count_gap": 0}


def test_compared_numbers():
    ref = _ref()
    same = compare.numbers(_prog(ref), ref, lr=0.1)
    assert [same[k] for k in compare.COMPARED] == [0.0] * 5
    # a state handed back unchanged: every leaf as large as the median
    # reads 1, in every segment
    stay = {f"s{k}": (lambda r: r["start"]) for k in range(4)}
    unchanged = compare.numbers(_prog(ref, **stay), ref, lr=0.1)
    assert unchanged["change_gap"] == pytest.approx(1.0)
    assert unchanged["grad_gap"] == pytest.approx(1.0)
    assert unchanged["step_gap"] == pytest.approx(1.0)
    altered = _prog(ref)
    altered["segments"][1]["losses"][1] *= 1.01
    nums = compare.numbers(altered, ref, lr=0.1)
    assert nums["loss_gap"] == pytest.approx(0.01)
    limits = dict.fromkeys(compare.COMPARED, 1e-3)
    ok, rows = compare.judge(nums, limits)
    assert not ok and [r[0] for r in rows] == list(compare.COMPARED)
    assert compare.judge(nums, dict(limits, loss_gap=0.02))[0]
    nan = dict(same, loss_gap=float("nan"))
    assert not compare.judge(nan, {k: 1.0 for k in compare.COMPARED})[0]


def test_step_gap_is_the_median_single_step_of_the_median_leaf():
    ref = _ref()

    def scale(f, leaves=range(4)):
        def change(r):
            return [s + (p - s) * (f if i in leaves else 1.0)
                    for i, (s, p) in enumerate(zip(r["start"],
                                                   r["params"]))]
        return change

    # one leaf of one single step far off (a flip): the median leaf holds
    flip = compare.numbers(_prog(ref, s2=scale(1.5, leaves=[0])), ref, lr=0.1)
    assert flip["step_gap"] == 0.0 and flip["change_gap"] == \
        pytest.approx(0.5)
    # every leaf of every single step off by 0.1%: step_gap reads it
    every = {f"s{k}": scale(1.001) for k in (0, 2, 3)}
    low = compare.numbers(_prog(ref, **every), ref, lr=0.1)
    assert low["step_gap"] == pytest.approx(1e-3)
    assert low["single_steps"] == pytest.approx([1e-3] * 3)


def test_a_leaf_moved_by_rounding_alone_is_not_counted():
    p0 = [np.ones(4), np.ones(4), np.ones(4)]
    p1 = [p0[0] - 0.1, p0[1] - 0.1, p0[2] - 1e-9]
    ref = {"segments": [_seg([1.0], p0, p1)]}
    prog = {"segments": [_seg([1.0], None, [p1[0], p1[1], p0[2] - 5e-9])]}
    nums = compare.numbers(prog, ref, lr=0.1)
    assert nums["leaves_counted"] == 2 and nums["change_gap"] == 0.0

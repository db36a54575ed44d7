"""The numbers that decide ``correct`` for a training cell, and their
limits.

The compared steps come in segments, each one call of the program: step
1, then one whole launch, then single steps.  The reference trains each
segment from where the program's state stood at its start (segment 1:
the initial weights it draws itself), on the same batches; see
``harness/mrf_train.py`` for why it follows the program segment by
segment.  The numbers:

* ``loss_gap``: the largest relative gap of a step's loss, over every
  compared step;
* ``grad_gap``: the first step's gradient as SGD took it, the change of
  the parameters over step 1 divided by the rate, by the worst leaf;
* ``change_gap``: the parameters' change over a segment, by the worst
  leaf, the largest over the segments (the launch's among them);
* ``step_gap``: for each single-step segment the change of its median
  leaf (the median over the leaves counted of the leaf's gap), and of
  those the median over the segments: round-off that flips a ReLU
  decision early in a step moves a few leaves of a few steps, a precision
  below the configuration's moves them all in every step;
* ``count_gap``: how far the state's step counters are from the steps and
  updates made (exact: limit 0).

"By the worst leaf": for each weight or bias the gap between the
program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger; the largest over the
leaves counted.  A leaf whose reference gradient (``grad``'s quantity) is
under a thousandth of the median leaf's moves by round-off alone and is
not counted.
"""

from __future__ import annotations

import numpy as np

SMALL_LEAF = 1e-3  # of the median leaf's gradient norm: not counted


def _norms(leaves) -> np.ndarray:
    return np.array([float(np.linalg.norm(np.asarray(a, dtype=np.float64)))
                     for a in leaves])


def leaf_gaps(got, want, counted) -> np.ndarray:
    """``|norm(got) - norm(want)| / max(norm(want), median)`` of each
    counted leaf."""
    g, w = _norms(got), _norms(want)
    scale = np.maximum(w, np.median(w))
    return np.abs(g - w)[counted] / scale[counted]


def _diff(after, before) -> list:
    return [np.asarray(a, np.float64) - np.asarray(b, np.float64)
            for a, b in zip(after, before)]


def numbers(prog: dict, ref: dict, *, lr: float) -> dict:
    """The compared numbers of ``prog`` against ``ref``: each has
    ``segments``, a list of ``{"losses": one a step, "params": the leaves
    after it}``; ``ref``'s segments also ``start``, the leaves both sides
    started from; ``prog`` has ``count_gap``.  SGD at rate ``lr``."""
    segs = list(zip(prog["segments"], ref["segments"], strict=True))
    lp = np.array([x for p, _ in segs for x in p["losses"]])
    lr_ = np.array([x for _, r in segs for x in r["losses"]])
    loss_gap = float(np.max(np.abs(lp - lr_) / np.abs(lr_)))
    p0, r0 = segs[0]
    g_ref = [d / -lr for d in _diff(r0["params"], r0["start"])]
    g_prog = [d / -lr for d in _diff(p0["params"], r0["start"])]
    gn = _norms(g_ref)
    counted = gn >= SMALL_LEAF * np.median(gn)
    changes, singles = [], []
    for p, r in segs:
        gaps = leaf_gaps(_diff(p["params"], r["start"]),
                         _diff(r["params"], r["start"]), counted)
        changes.append(float(gaps.max()))
        if len(r["losses"]) == 1:
            singles.append(float(np.median(gaps)))
    return {"loss_gap": loss_gap,
            "grad_gap": float(leaf_gaps(g_prog, g_ref, counted).max()),
            "change_gap": max(changes),
            "step_gap": float(np.median(singles)) if singles else 0.0,
            "count_gap": float(prog.get("count_gap", 0)),
            "single_steps": singles,
            "leaves_counted": int(counted.sum()),
            "leaves": len(counted)}


COMPARED = ("loss_gap", "grad_gap", "change_gap", "step_gap", "count_gap")


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every compared number at or
    under its limit; a number that is not finite fails."""
    rows = [(k, nums[k], float(limits[k])) for k in COMPARED]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows

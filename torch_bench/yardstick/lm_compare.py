"""The numbers that decide ``correct`` for an LM training cell, and their
limits (``limits/<cell>.json``).

The compared steps are the set-up's calls, one step each, each call
resuming from the checkpoint the one before left: step 1 from the initial
weights, then ``compared_steps - 1`` single steps.  The reference
(``yardstick/mamba2_ref.py``, float32) computes the loss and the gradient
of each step on the tokens it draws itself (``yardstick/lm_data.py``): of
step 1 at the weights it draws itself (``yardstick/lm_init.py``), of each
later step at the parameters the program handed back from the step
before.  From that gradient, clipped to a global norm of 1.0, and from
the Adam moments the program handed back with those parameters (zero for
step 1), it computes each step's Adam update (:func:`adam_update`), which
the program's change of its parameters is held against.  The numbers:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``gnorm_gap``: the largest relative gap of a step's global gradient norm
  before clipping;
* ``sign_gap``: step 1.  From zero moments Adam's first update is
  ``-lr g / (|g| + eps)`` of the clipped gradient: it carries the
  gradient's sign alone.  For each kind of parameter (the embedding, a
  projection, a conv's taps, a norm's gain: one leaf a layer), pooled over
  the layers, the share of its entries whose update does not move against
  the reference's gradient (an update of 0 counts as not), each entry
  weighted by the reference gradient's magnitude; the largest over the
  kinds that hold at least ``MIN_SHARE`` of the parameters (at
  mamba2-1.3b's widths the embedding and the x, z, B, C, dt and out
  projections).  A small kind (``A_log``, ``dt_bias``, ``D``: 64 entries
  a layer) reads its bf16 round-off as a share that swings threefold from
  seed to seed; pooled and large, a kind reads it within a few percent,
  so a fault's share stands clear of it;
* ``update_gap``: every step after the first.  For each kind, pooled over
  the layers, ``sum w |got - want| / sum w |want|`` of the program's
  change ``got`` and the reference's Adam update ``want``, each entry
  weighted by the magnitude of the reference's new first moment ``w``
  (the update's numerator); the largest over the large kinds, as
  ``sign_gap``, and over the steps.  A state left unchanged reads 1, an
  update that moves against the reference's reads 2 or more; moments,
  a step count or a rate other than the reference's read as the share of
  the update they move.  Both sides hold the same moments from before
  the step, so the program's bf16 gradient moves only the new gradient's
  share of them;
* ``init_gap``: step 1.  The largest move of any entry from the
  reference's initial weights, over the rate, less 1.  Adam's first step
  moves an entry by at most the rate; a program that starts from other
  weights moves some entry by more.  Sound, the reading is float32
  round-off of the parameters (half an ulp of a parameter near 4.6, the
  ``dt_bias``, is 8e-4 of the rate 3e-4);
* ``scan_gap``: the SSD scan as the program ran it.  The first scan of
  each compared step (the first layer's forward), its inputs and output
  taken as the program passed them, on the first sequence: the relative
  Frobenius gap of the program's output from the reference's
  (``mamba2_ref.ssm``, the semiseparable matrix) on the same inputs, the
  largest over the steps.  It reads the precision the scan was computed
  in: the configuration states float32;
* ``count_gap``: how far the state's step counters are from the steps
  made (exact: limit 0).
"""

from __future__ import annotations

import math

import torch

COMPARED = ("loss_gap", "gnorm_gap", "sign_gap", "update_gap", "init_gap",
            "scan_gap", "count_gap")
#: the launcher's Adam, as the configuration's ``assumed`` states it
B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_GRAD_NORM = 1.0


def global_norm(grads) -> float:
    return math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads))


def clip_scale(norm: float) -> float:
    """The factor that clips a gradient of global norm ``norm``."""
    return min(MAX_GRAD_NORM / max(norm, 1e-12), 1.0)


def adam_update(grad, mu, nu, step: int, lr: float) -> tuple:
    """(the update Adam makes at ``step`` (1, 2, ...) from the clipped
    gradient ``grad`` and the moments ``mu``, ``nu`` it held before, the
    new first moment), in float64."""
    g = grad.double()
    m = B1 * mu.double() + (1 - B1) * g
    v = B2 * nu.double() + (1 - B2) * g * g
    mhat, vhat = m / (1 - B1 ** step), v / (1 - B2 ** step)
    return -lr * mhat / (torch.sqrt(vhat) + EPS), m


MIN_SHARE = 1 / 256  # of the model's parameters a kind holds, pooled


def sign_counts(update: torch.Tensor, grad: torch.Tensor) -> tuple:
    """(the |grad| weight of the entries of ``update`` that do not move
    against ``grad``, the |grad| weight of all of them)."""
    weight = grad.abs().double()
    wrong = torch.sign(update) != -torch.sign(grad)
    return float((weight * wrong).sum()), float(weight.sum())


def sign_share(update: torch.Tensor, grad: torch.Tensor) -> float:
    """The |grad|-weighted share of the entries of ``update`` that do not
    move against ``grad``."""
    wrong, total = sign_counts(update, grad)
    return wrong / total if total else 0.0


def update_counts(got: torch.Tensor, want: torch.Tensor,
                  weight: torch.Tensor) -> tuple:
    """(``sum w |got - want|``, ``sum w |want|``) with ``w = |weight|``."""
    w = weight.abs().double()
    want = want.double()
    return (float((w * (got.double() - want).abs()).sum()),
            float((w * want.abs()).sum()))


def pooled(kinds: dict) -> float:
    """``kinds``: name -> (part, whole, entries), each summed over the
    kind's leaves (:func:`sign_counts`, :func:`update_counts`); the
    largest share ``part / whole`` among the kinds that hold at least
    ``MIN_SHARE`` of the entries."""
    least = MIN_SHARE * sum(n for _, _, n in kinds.values())
    return max(part / whole for part, whole, n in kinds.values()
               if n >= least and whole > 0)


def scan_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The relative Frobenius gap of the scan's output ``got`` from
    ``want``."""
    want = want.double()
    return float(torch.linalg.vector_norm(got.double() - want)
                 / torch.linalg.vector_norm(want))


def numbers(prog: dict, ref: dict) -> dict:
    """``prog``: ``losses`` and ``grad_norms`` (one a compared step),
    ``sign_kinds`` (step 1's update, for :func:`pooled`), ``update_kinds``
    (one a later step, for :func:`pooled`), ``init_move`` (step 1's
    largest move over the rate), ``scan_gaps`` (one a step) and
    ``count_gap``; ``ref``: ``losses`` and ``grad_norms``."""
    def gap(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b, strict=True))
    return {"loss_gap": gap(prog["losses"], ref["losses"]),
            "gnorm_gap": gap(prog["grad_norms"], ref["grad_norms"]),
            "sign_gap": pooled(prog["sign_kinds"]),
            "update_gap": max((pooled(k) for k in prog["update_kinds"]),
                              default=0.0),
            "init_gap": prog["init_move"] - 1.0,
            "scan_gap": max(prog["scan_gaps"]),
            "count_gap": float(prog["count_gap"])}


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every compared number at or
    under its limit; a number that is not finite fails."""
    rows = [(k, nums[k], float(limits[k])) for k in COMPARED]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows

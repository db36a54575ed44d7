"""The plain reference of MRF training: a ReLU MLP trained tile by tile
in NumPy, one SGD or Adam update a tile, in float64.

``train_chains`` trains independent chains (each from its own start) in
lockstep, one stacked product a layer for all of them.

A tile of ``t`` samples: forward ``h = relu(h @ W + b)`` (the last layer
linear), loss ``sum((out - y)^2) / (t * out_dim)`` (the mean squared error
over the tile's samples and outputs), backward by hand (``dz = 2 (out -
y) / (t * out_dim)``; for each layer from the last ``dW = h_prev^T dz``,
``db = sum(dz)``, ``dh = dz W^T`` taken before the update, ``dz = dh *
(h_prev > 0)``), then the update: SGD ``p - lr g``, or Adam with its
moments and bias corrections at update ``t`` (counted over tiles).  A
step's loss is the mean of its tiles' losses.

``precision="tf32"`` is the control: the same arithmetic in float32 with
every matrix product's operands rounded to TF32 (10 mantissa bits, to
nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and summed in
float32, the step below the float32 the configurations state.
``fault="half_batch"`` trains each step on the first half of its rows
only, the mean taken over them (a planted fault, for the limits).

Imports nothing of the program: it is handed the initial weights and the
batches as arrays (``yardstick.mrf_data`` makes both from the seed).
"""

from __future__ import annotations

import numpy as np

PRECISIONS = ("f64", "tf32")
FAULTS = (None, "half_batch")


def tf32(a: np.ndarray) -> np.ndarray:
    """float32 ``a`` rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def train(params0, x, y, *, tile: int, optimizer: str, lr: float,
          steps: int, adam=(0.9, 0.999, 1e-8), precision: str = "f64",
          fault: str | None = None) -> dict:
    """``steps`` steps over ``x`` (steps * B, d_in) / ``y`` (steps * B,
    d_out), each step's B rows in tiles of ``tile``, from ``params0``
    (``[(w (in, out), b (out,))]`` arrays).

    Returns ``losses`` (one a step), ``first`` (each leaf after step 1:
    the params for SGD, Adam's first moment for Adam, as ``[w, b, ...]``),
    ``params`` after the last step (``[w, b, ...]``) and ``updates`` (the
    number of tile updates made)."""
    out = train_chains([params0], np.asarray(x)[None], np.asarray(y)[None],
                       tile=tile, optimizer=optimizer, lr=lr, steps=steps,
                       adam=adam, precision=precision, fault=fault)
    return {"losses": out["losses"][0], "first": out["first"][0],
            "params": out["params"][0], "updates": out["updates"]}


def train_chains(starts, x, y, *, tile: int, optimizer: str, lr: float,
                 steps: int, adam=(0.9, 0.999, 1e-8), precision: str = "f64",
                 fault: str | None = None) -> dict:
    """Independent chains in lockstep, each as :func:`train` trains one:
    chain ``c`` from ``starts[c]`` (``[(w, b)]``, fresh optimizer state)
    over ``x[c]`` (steps * B, d_in) / ``y[c]``.  The same arithmetic, one
    stacked product a layer for all chains, so ``C`` chains cost about
    what one does.  Returns :func:`train`'s keys, a list over chains
    each (``updates`` is a chain's)."""
    if precision not in PRECISIONS or fault not in FAULTS:
        raise ValueError(f"precision {precision!r}, fault {fault!r}")
    if optimizer not in ("sgd", "adam"):
        raise ValueError(f"optimizer {optimizer!r}")
    dt = np.float64 if precision == "f64" else np.float32
    mm = (np.matmul if precision == "f64"
          else (lambda a, b: np.matmul(tf32(a), tf32(b))))
    x, y = np.asarray(x, dtype=dt), np.asarray(y, dtype=dt)
    rows = x.shape[1] // steps
    if rows * steps != x.shape[1] or rows % tile:
        raise ValueError(f"{x.shape[1]} rows are not {steps} steps of whole "
                         f"tiles of {tile}")
    ps = [np.stack([np.asarray(t, dtype=dt) for t in leaf])
          for leaf in zip(*[[t for wb in st for t in wb] for st in starts])]
    ms = [np.zeros_like(p) for p in ps]
    vs = [np.zeros_like(p) for p in ps]
    b1, b2, eps = adam
    n_layers = len(ps) // 2
    out_dim = y.shape[2]
    denom = dt(tile * out_dim)
    rate = dt(lr)
    losses, first, t = [], None, 0
    for s in range(steps):
        used = rows // 2 if fault == "half_batch" else rows
        tile_losses = []
        for r0 in range(s * rows, s * rows + used, tile):
            xt, yt = x[:, r0:r0 + tile], y[:, r0:r0 + tile]
            hs = [xt]
            for l in range(n_layers):
                z = mm(hs[-1], ps[2 * l]) + ps[2 * l + 1][:, None]
                hs.append(z if l == n_layers - 1 else np.maximum(z, 0))
            diff = hs[-1] - yt
            tile_losses.append(np.sum(diff * diff, axis=(1, 2)) / denom)
            dz = 2 * diff / denom
            t += 1
            if optimizer == "adam":
                c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            for l in range(n_layers - 1, -1, -1):
                h_prev = hs[l]
                if l > 0:
                    dh = mm(dz, ps[2 * l].swapaxes(1, 2))
                grads = (mm(h_prev.swapaxes(1, 2), dz), dz.sum(axis=1))
                for j, g in enumerate(grads):
                    i = 2 * l + j
                    if optimizer == "sgd":
                        ps[i] -= rate * g
                    else:
                        ms[i] = dt(b1) * ms[i] + dt(1 - b1) * g
                        vs[i] = dt(b2) * vs[i] + dt(1 - b2) * g * g
                        ps[i] -= rate * ((ms[i] / dt(c1))
                                         / (np.sqrt(vs[i] / dt(c2))
                                            + dt(eps)))
                if l > 0:
                    dz = dh * (h_prev > 0)
        losses.append(np.mean(np.asarray(tile_losses, np.float64), axis=0))
        if s == 0:
            first = [np.array(a) for a in (ps if optimizer == "sgd" else ms)]
    chains = range(len(starts))
    return {"losses": [[float(l[c]) for l in losses] for c in chains],
            "first": [[a[c] for a in first] for c in chains],
            "params": [[a[c] for a in ps] for c in chains],
            "updates": t}

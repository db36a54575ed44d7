"""The fused training kernel's plain PyTorch version and its autograd oracle
(counterpart of ``repro.kernels.fused_train.ref`` and of the kernel body
``train_tile`` in ``repro.kernels.fused_train.kernel``).

* :func:`fused_train_plain` is the **plain version** of
  ``csrc/fused_train.cu``: the same inputs (the packed net, its moments),
  the same outputs, and per tile :func:`train_tile_plain`, which mirrors
  ``kernel.py:57-108`` op for op — forward, MSE over the ``out_dim``
  columns with ``denom = tb * out_dim`` and ``dz = 2 * diff / denom``, and
  the backward that takes ``dh`` through the layer's (fake-quantized)
  weights **before** updating them.  Kernel wrappers run it for CPU
  tensors; ``chip_smoke.py`` holds the kernel against it on the card.
* :func:`ref_train` is the oracle: sequential SGD over batch tiles with
  autograd gradients, the straight-through estimator written
  ``w + (q - w).detach()`` (``ref.py:17-44``).

Divisions that the kernel takes as IEEE quotients divide by device
tensors here: CUDA PyTorch turns a division by a Python scalar into a
multiply by its reciprocal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import mrf_net


class AdamRule(NamedTuple):
    """Adam's constants, as ``optim.optimizers.adam`` defaults them."""
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


def packed_size(widths) -> int:
    """Floats of a net packed as, per layer, W (K, N) row-major then b (N,)."""
    return sum(k * n + n for k, n in zip(widths[:-1], widths[1:]))


def layer_views(flat: torch.Tensor, widths) -> list:
    """``[(w (K, N), b (N,))]`` views into a packed net."""
    out, at = [], 0
    for k, n in zip(widths[:-1], widths[1:]):
        out.append((flat[at:at + k * n].view(k, n),
                    flat[at + k * n:at + k * n + n]))
        at += k * n + n
    return out


def _div(a: torch.Tensor, v: float) -> torch.Tensor:
    return a / torch.full((), v, dtype=a.dtype, device=a.device)


def quant_levels(w: torch.Tensor) -> tuple:
    """``(levels, s)`` of the per-output-column int8 fake-quant: ``s =
    max_k |w[k, n]| / 127 + 1e-12`` and ``levels = clamp(rint(w / s), -127,
    127)``."""
    s = _div(torch.amax(torch.abs(w), dim=0, keepdim=True), 127.0) + 1e-12
    return torch.clamp(torch.round(w / s), -127, 127), s


def fake_quantize_columns(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-column int8 fake-quant of the live weights
    (``kernel.py:71-76``)."""
    levels, s = quant_levels(w)
    return levels * s


def sgd_rule(p, g, *, lr: float) -> None:
    """The paper's Eq. 2 update, in place: ``p - lr * g``."""
    p.copy_(p - lr * g)


def adam_rule(p, m, v, g, *, lr: float, c1, c2, rule: AdamRule) -> None:
    """One Adam update in place, op for op ``multistep.py:145-152``
    (``c1``, ``c2``: the bias corrections of this update)."""
    m_new = rule.b1 * m + (1 - rule.b1) * g
    v_new = rule.b2 * v + (1 - rule.b2) * torch.square(g)
    mhat = m_new / c1
    vhat = v_new / c2
    step_ = lr * (mhat / (torch.sqrt(vhat) + rule.eps) + rule.weight_decay * p)
    p.copy_(p - step_)
    m.copy_(m_new)
    v.copy_(v_new)


def train_tile_plain(x, y, layers, update, *, qat: bool) -> torch.Tensor:
    """One batch tile: forward, masked MSE, backward, with the optimizer
    rule injected as ``update(l, dw, db)``, called once per layer in
    backward order.  ``layers``: ``[(w, b)]`` tensors updated in place by
    ``update``.  Returns the tile's loss."""
    tb, out_dim = y.shape
    n_layers = len(layers)
    h, hidden, wqs = x, [], []
    for l, (w, b) in enumerate(layers):
        # the fake-quantized weights of the forward serve the backward too:
        # a layer's weights do not change between its forward and its dh
        wl = fake_quantize_columns(w) if qat else w
        wqs.append(wl)
        z = h @ wl + b
        h = z if l == n_layers - 1 else torch.relu(z)
        if l < n_layers - 1:
            hidden.append(h)

    diff = h - y
    denom = torch.full((), float(tb * out_dim), device=x.device)
    loss = torch.sum(diff * diff) / denom

    dz = 2.0 * diff / denom
    for l in range(n_layers - 1, -1, -1):
        h_prev = x if l == 0 else hidden[l - 1]
        if l > 0:  # propagate the delta BEFORE updating this layer
            dh = dz @ wqs[l].T
            relu_mask = (h_prev > 0.0).to(torch.float32)
        dw = h_prev.T @ dz
        db = torch.sum(dz, dim=0)
        update(l, dw, db)
        if l > 0:
            dz = dh * relu_mask
    return loss


def fused_train_plain(x, y, params, widths, *, lr: float, tile_batch: int,
                      qat: bool = False, moments=None, step0=None,
                      rule: AdamRule = AdamRule()):
    """The kernel's function in plain PyTorch: every ``tile_batch`` rows of
    ``x``/``y`` one update of the packed net ``params``, in order.

    ``moments=(mu, nu)`` (packed like ``params``) and ``step0`` (int32, the
    Adam step before the call) select Adam, with ``t = step0 + tile + 1``;
    otherwise SGD.  Returns ``(params, mu, nu, losses (n_tiles,))``, new
    tensors (``mu``/``nu`` None for SGD); the inputs are not mutated.
    """
    p = params.clone()
    layers = layer_views(p, widths)
    mu = nu = None
    if moments is not None:
        mu, nu = (m.clone() for m in moments)
        mws, nws = layer_views(mu, widths), layer_views(nu, widths)
        s0 = step0.reshape(())
    n_tiles = x.shape[0] // tile_batch
    losses = []
    for t in range(n_tiles):
        rows = slice(t * tile_batch, (t + 1) * tile_batch)
        if moments is None:
            def update(l, dw, db):
                sgd_rule(layers[l][0], dw, lr=lr)
                sgd_rule(layers[l][1], db, lr=lr)
        else:
            step = (s0 + t + 1).to(torch.float32)
            c1 = 1.0 - torch.pow(rule.b1, step)
            c2 = 1.0 - torch.pow(rule.b2, step)

            def update(l, dw, db):
                for j, g in ((0, dw), (1, db)):
                    adam_rule(layers[l][j], mws[l][j], nws[l][j], g, lr=lr,
                              c1=c1, c2=c2, rule=rule)
        losses.append(train_tile_plain(x[rows], y[rows], layers, update,
                                       qat=qat))
    losses = torch.stack(losses) if losses else torch.zeros(
        (0,), device=x.device)
    return p, mu, nu, losses


def stream_divergence(train, x, y, params, widths, *, lr: float,
                      qat: bool = False) -> dict:
    """Holds ``train`` — one SGD update per row (tile 1), ``(x_row, y_row,
    params) -> (params, losses)``, e.g. the kernel's wrapper — against the
    plain version over the rows of ``x``/``y``, one call per row, from the
    packed net ``params``.

    The two take their sums in other orders, so their nets part by rounding.
    With QAT a weight an ulp to either side of a rounding tie takes another
    int8 level, a jump of a whole step ``s``, and from there the two runs
    train different nets.  So the comparison is made two ways:

    * ``local_err``: from each net ``train`` reaches, one plain update; the
      largest difference to ``train``'s next net and loss, over every row;
    * ``free_err``: the two runs side by side from the same start; the
      largest difference of nets and losses before ``first_flip``, the first
      update whose two input nets differ in an int8 level (``None``: none
      did; never without QAT, where ``free_err`` covers every row).

    Also ``flipped`` (int8 levels that differ at the end; 0 without QAT),
    ``end_err`` (the largest difference of the two final nets), and
    ``train``'s final net and per-row losses (``params``, ``losses``).
    """
    def plain(xr, yr, p):
        new, _, _, loss = fused_train_plain(xr, yr, p, widths, lr=lr,
                                            tile_batch=1, qat=qat)
        return new, loss

    def levels(p):
        return torch.cat([quant_levels(w)[0].reshape(-1)
                          for w, _ in layer_views(p, widths)])

    def err(a, b):
        return float((a - b).abs().max())

    got = want = params
    local = free = 0.0
    first_flip, losses = None, []
    for i in range(x.shape[0]):
        xr, yr = x[i:i + 1], y[i:i + 1]
        if qat and first_flip is None and not torch.equal(levels(got),
                                                          levels(want)):
            first_flip = i
        nxt, loss = train(xr, yr, got)
        one_p, one_l = plain(xr, yr, got)
        local = max(local, err(nxt, one_p), err(loss, one_l))
        want, want_l = plain(xr, yr, want)
        if first_flip is None:
            free = max(free, err(nxt, want), err(loss, want_l))
        got = nxt
        losses.append(loss.reshape(-1))
    flipped = int((levels(got) != levels(want)).sum()) if qat else 0
    return {"local_err": local, "free_err": free, "first_flip": first_flip,
            "flipped": flipped, "end_err": err(got, want), "params": got,
            "losses": torch.cat(losses) if losses else x.new_zeros((0,))}


def _tile_loss(params, x, y, qat: bool):
    if qat:
        def fq(w):
            q = fake_quantize_columns(w)
            return w + (q - w).detach()  # STE: the forward sees q
        params = [{"w": fq(p["w"]), "b": p["b"]} for p in params]
    pred = mrf_net.forward(params, x)
    return torch.mean(torch.square(pred - y))


def ref_train(params, x, y, *, lr: float, tile_batch: int, qat: bool = False):
    """Oracle: ``(new_params, per-tile losses)`` of sequential SGD over the
    tiles of x (B, D_in) / y (B, out), gradients by autograd."""
    if x.shape[0] % tile_batch:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                         f"tile_batch {tile_batch}")
    params = [{k: v.detach() for k, v in layer.items()} for layer in params]
    losses = []
    for t in range(x.shape[0] // tile_batch):
        rows = slice(t * tile_batch, (t + 1) * tile_batch)
        live = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
                for layer in params]
        loss = _tile_loss(live, x[rows], y[rows], qat)
        flat = [layer[k] for layer in live for k in ("w", "b")]
        grads = iter(torch.autograd.grad(loss, flat))
        params = [{k: (layer[k] - lr * next(grads)).detach()
                   for k in ("w", "b")} for layer in live]
        losses.append(loss.detach())
    return params, torch.stack(losses)

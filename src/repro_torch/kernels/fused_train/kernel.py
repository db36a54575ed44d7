"""Wrapper of the fused training CUDA kernel (``csrc/fused_train.cu``) for
one training step: ``fused_train_call``, the port of
``repro.kernels.fused_train.kernel.fused_train_call`` (B1).

The kernel trains the whole net over sequential batch tiles in one launch —
forward, masked MSE, hand-derived backward, in-place update — with the
layers at their true widths, packed in one fp32 buffer in the JAX
``(in, out)`` layout (``ref.layer_views``; no 128-lane padding).  B1 is the
K = 1 case of the same kernel as ``multistep.py``'s B2 and B3:
:func:`run_fused_train` launches it for all three, and each wrapper counts
its own launches in ``.launches``.

A CPU tensor runs the plain version (``ref.fused_train_plain``); a CUDA
tensor launches the kernel or raises.  Outputs are new tensors; inputs are
not mutated.  The launch goes on the current stream and does not
synchronise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_train.ref import (AdamRule, fused_train_plain,
                                                 packed_size)

SMEM_MAX = 232_448  # bytes of shared memory a block may use on sm_90
MAX_LAYERS = 16     # kMaxLayers in the .cu


def smem_bytes(widths) -> int:
    """Shared memory of one launch: every layer's W with rows padded by one
    float, and its bias."""
    return 4 * sum(k * (n + 1) + n for k, n in zip(widths[:-1], widths[1:]))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("fused_train").fused_train_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_widths(widths) -> tuple:
    widths = tuple(int(w) for w in widths)
    if not 2 <= len(widths) <= MAX_LAYERS + 1 or min(widths) < 1:
        raise ValueError(f"widths {widths}: want 1..{MAX_LAYERS} layers of "
                         f"positive width")
    return widths


def _check_tensor(name, t, dev, shape, dtype=torch.float32):
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, x on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype}{tuple(shape)}, got "
                         f"{t.dtype}{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def run_fused_train(x, y, params, widths, *, lr: float, tile_batch: int,
                    qat: bool = False, moments=None, step0=None,
                    rule: AdamRule = AdamRule()):
    """Every ``tile_batch`` rows of x (rows, widths[0]) / y (rows,
    widths[-1]) one update of the packed net ``params``, in order; Adam with
    ``moments=(mu, nu)`` and the int32 ``step0``, else SGD.

    Returns ``(params, mu, nu, losses (n_tiles,), launched)``;
    ``launched`` is False on the CPU and when there are no rows.
    """
    widths = _check_widths(widths)
    rows = x.shape[0]
    if tile_batch < 1 or rows % tile_batch:
        raise ValueError(f"{rows} rows are not a whole number of tiles of "
                         f"{tile_batch}")
    if (moments is None) != (step0 is None):
        raise ValueError("Adam needs both moments and step0; SGD neither")
    kw = dict(lr=lr, tile_batch=tile_batch, qat=qat, moments=moments,
              step0=step0, rule=rule)
    if x.device.type == "cpu":
        return (*fused_train_plain(x, y, params, widths, **kw), False)
    if x.device.type != "cuda":
        raise ValueError(f"fused_train: unsupported device {x.device}")
    dev = x.device
    n = packed_size(widths)
    _check_tensor("x", x, dev, (rows, widths[0]))
    _check_tensor("y", y, dev, (rows, widths[-1]))
    _check_tensor("params", params, dev, (n,))
    if moments is not None:
        _check_tensor("mu", moments[0], dev, (n,))
        _check_tensor("nu", moments[1], dev, (n,))
        _check_tensor("step0", step0, dev, (1,), torch.int32)
    if smem_bytes(widths) > SMEM_MAX:
        raise ValueError(f"net {widths} needs {smem_bytes(widths)} B of "
                         f"shared memory; a block has {SMEM_MAX}")
    build.check_device(dev)
    p_out = torch.empty_like(params)
    mu_out = nu_out = None
    if moments is not None:
        mu_out, nu_out = torch.empty_like(moments[0]), torch.empty_like(
            moments[1])
    n_tiles = rows // tile_batch
    losses = torch.empty((n_tiles,), dtype=torch.float32, device=dev)
    if rows == 0:  # nothing to launch, nothing to count
        p_out.copy_(params)
        if moments is not None:
            mu_out.copy_(moments[0])
            nu_out.copy_(moments[1])
        return p_out, mu_out, nu_out, losses, False
    act = torch.empty((tile_batch * sum(widths[1:]),), device=dev)
    dz = torch.empty((2 * tile_batch * max(widths),), device=dev)
    wq = torch.empty((smem_bytes(widths) // 4,), device=dev) if qat else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _entry()(
        x.data_ptr(), y.data_ptr(), rows, tile_batch,
        (ctypes.c_int * len(widths))(*widths), len(widths) - 1,
        params.data_ptr(), p_out.data_ptr(),
        ptr(moments[0] if moments else None),
        ptr(moments[1] if moments else None), ptr(mu_out), ptr(nu_out),
        ptr(step0), losses.data_ptr(), act.data_ptr(), dz.data_ptr(), ptr(wq),
        lr, rule.b1, rule.b2, 1 - rule.b1, 1 - rule.b2, rule.eps,
        rule.weight_decay, int(qat), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_train kernel launch failed: CUDA error "
                           f"{err}")
    return p_out, mu_out, nu_out, losses, True


def fused_train_call(x, y, params, *, widths, lr: float, tile_batch: int,
                     qat: bool = False):
    """One fused SGD pass over the batch (B1): ``(params, losses)``.

    x (B, widths[0]), y (B, widths[-1]) fp32; ``params`` the packed net
    (``ops.pack_params``); B a multiple of ``tile_batch``.
    """
    p, _, _, losses, launched = run_fused_train(
        x, y, params, widths, lr=lr, tile_batch=tile_batch, qat=qat)
    if launched:
        fused_train_call.launches += 1
    return p, losses


fused_train_call.launches = 0

"""Multi-step fused training: K steps per launch, the net (and Adam's
moments) resident across all of them — the ports of
``repro.kernels.fused_train.multistep.fused_train_multistep_call`` (B2, SGD)
and ``fused_train_adam_call`` (B3, Adam).

Both wrap the same CUDA kernel as ``kernel.fused_train_call`` (B1): the
K steps' batches are staged back to back (step k = rows ``[k*B, (k+1)*B)``)
and the kernel walks their ``K*B/tile`` tiles in order, so tile
``k*n_tiles + j`` sees the net as every earlier tile left it.  A K-step
launch therefore equals K single-step launches bit for bit.  Each wrapper
counts its own launches in ``.launches``.
"""

from __future__ import annotations

from repro_torch.kernels.fused_train.kernel import run_fused_train
from repro_torch.kernels.fused_train.ref import AdamRule


def fused_train_multistep_call(x, y, params, *, widths, lr: float,
                               tile_batch: int, qat: bool = False,
                               cluster: int | None = None):
    """K steps of in-kernel SGD in one launch (B2): ``(params, per-tile
    losses (K*B/tile,))``.  ``tile_batch`` must divide the per-step batch
    (``ops.effective_tile``) so that no tile straddles two steps."""
    p, _, _, losses, launched = run_fused_train(
        x, y, params, widths, lr=lr, tile_batch=tile_batch, qat=qat,
        cluster=cluster)
    if launched:
        fused_train_multistep_call.launches += 1
    return p, losses


def fused_train_adam_call(step0, x, y, params, mu, nu, *, widths, lr: float,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8, weight_decay: float = 0.0,
                          tile_batch: int, qat: bool = False,
                          cluster: int | None = None):
    """K steps of in-kernel Adam in one launch (B3).

    ``step0``: (1,) int32 on the device, the Adam step before the launch;
    update ``j`` of the launch uses ``t = step0 + j + 1``.  ``mu``/``nu``:
    the moments, packed like ``params``.  Returns ``(params, mu, nu,
    per-tile losses)``.
    """
    p, m, v, losses, launched = run_fused_train(
        x, y, params, widths, lr=lr, tile_batch=tile_batch, qat=qat,
        moments=(mu, nu), step0=step0,
        rule=AdamRule(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay),
        cluster=cluster)
    if launched:
        fused_train_adam_call.launches += 1
    return p, m, v, losses


fused_train_multistep_call.launches = 0
fused_train_adam_call.launches = 0

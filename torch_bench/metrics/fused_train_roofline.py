"""``fused_train_roofline``: the least time of the window's training
work on the whole chip (``yardstick.work``: float32 operations at 67
TFLOP/s against bytes at 3.35 TB/s) over the device time of the training
kernel (``fused_train_kernel``) in the traced window, in %.  Nothing when
the trace holds another number of its launches than the program counted
(the profiler dropped records) or none."""

from torch_bench.yardstick import work

KERNEL = "fused_train_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, count = ctx.trace.seconds(lambda name: KERNEL in name)
    if count == 0 or count != ctx.launches:
        return None
    ops = work.train_ops(ctx.widths, ctx.samples, ctx.tile, ctx.optimizer)
    nbytes = work.train_bytes(ctx.widths, ctx.samples, ctx.tile,
                              ctx.optimizer, launches=ctx.launches)
    least, _ = work.least_seconds(ops, nbytes)
    return 100.0 * least / seconds

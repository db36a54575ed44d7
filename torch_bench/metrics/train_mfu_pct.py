"""``train_mfu_pct``: the operations of every sample the window trained
(``yardstick.work.train_ops``, the same count whatever implements the
step) over the window's host-clock seconds at the chip's float32 peak, in
%."""

from torch_bench.yardstick import work


def read(ctx):
    if ctx.samples <= 0 or ctx.window_s <= 0:
        return None
    ops = work.train_ops(ctx.widths, ctx.samples, ctx.tile, ctx.optimizer)
    return 100.0 * ops / (ctx.window_s * work.H100["peak_fp32_flops"])

"""``lm_train_mfu_pct``: the model FLOP of the steps the window trained
(``yardstick.lm_work.model_flops``: the forward's products and the SSD
scan's, three times for forward and backward; a recompute is not model
work) over the window's host-clock seconds at the chip's dense bf16 peak,
in %."""


def read(ctx):
    if ctx.samples <= 0 or ctx.window_s <= 0:
        return None
    from torch_bench.yardstick import lm_work

    steps = ctx.samples // ctx.batch
    flops = steps * lm_work.model_flops(ctx.model, ctx.batch, ctx.seq)
    return 100.0 * flops / (ctx.window_s * lm_work.H100["peak_bf16_flops"])

"""``ssd_scan_roofline``: the SSD scan's least time in a step
(``yardstick.lm_work.scan_least_seconds``: its products forward and
backward at the float32 peak against its inputs and outputs read and
written once at the HBM rate, whatever implements the scan) over its
device time a step (``harness.lm_trace.scan_ms_per_step``, as
``ssd_scan_ms_per_step`` reads it), in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    from torch_bench.harness import lm_trace
    from torch_bench.yardstick import lm_work

    ms = lm_trace.scan_ms_per_step(ctx.trace, getattr(ctx, "rec", None))
    if ms is None:
        return None
    least = lm_work.scan_least_seconds(ctx.model, ctx.batch, ctx.seq)
    return 100.0 * least / (ms / 1e3)

"""``ssd_scan_ms_per_step``: the device time of the kernels the SSD scan
launched in the traced call, forward, recompute and backward (launched
inside the program's ``model.ssd`` and ``model.ssd_bwd`` spans), over the
steps the call made, in ms (``harness.lm_trace.scan_ms_per_step``).
Nothing without the spans, or where a span count differs from its
counter."""


def read(ctx):
    if ctx.trace is None:
        return None
    from torch_bench.harness import lm_trace

    return lm_trace.scan_ms_per_step(ctx.trace, getattr(ctx, "rec", None))

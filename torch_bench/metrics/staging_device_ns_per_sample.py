"""``staging_device_ns_per_sample``: the device time of every operation
in the traced window but the training kernel and copies or sets (the
batches' simulation and augmentation, their concatenation, the losses'
sums), in ns a sample trained."""

KERNEL = "fused_train_kernel"  # the training kernel, read by its own metric
COPIES = ("Memcpy", "Memset")


def read(ctx):
    if ctx.trace is None or ctx.samples <= 0:
        return None
    seconds, count = ctx.trace.seconds(
        lambda name: KERNEL not in name and not name.startswith(COPIES))
    if count == 0:
        return None
    return seconds * 1e9 / ctx.samples

"""The fp32 block kernels' share of the traced training window's device
time (%): the kernels of kernels/fp32/ over every kernel, copy and memset.
Nothing when no such kernel ran."""


def read(ctx):
    seconds = ctx.kernel_seconds("fp32")
    if seconds <= 0:
        return None
    return 100.0 * seconds / ctx.trace.device_seconds()

"""The full blocks' four bf16 products (qkv, attention output, the MLP's
two) against their roofline (%): the least time the shapes allow at the
card's bf16 and memory peaks, over the device time of the kernels of
kernels/gemm/. Nothing when no such kernel ran."""


def read(ctx):
    seconds = ctx.kernel_seconds("gemm")
    if seconds <= 0:
        return None
    y, w = ctx.yardstick, ctx.work
    bound = y.block_gemm_bound_s(ctx.cfg, w["images"] * w["passes"], 2, y.PEAK_BF16_FLOPS)
    return 100.0 * bound / seconds

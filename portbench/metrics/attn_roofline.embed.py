"""The full blocks' attention cores in bf16 against their roofline (%):
the larger of QK^T and PV's operations at the bf16 peak and q, k, v and
the output's bytes at the memory rate, over the device time of the kernels
of kernels/attn/. Nothing when no such kernel ran."""


def read(ctx):
    seconds = ctx.kernel_seconds("attn")
    if seconds <= 0:
        return None
    y, w = ctx.yardstick, ctx.work
    bound = y.attention_bound_s(ctx.cfg, w["images"] * w["passes"], 2, y.PEAK_BF16_FLOPS)
    return 100.0 * bound / seconds

"""The EVA02 full blocks' attention cores in bf16 against their roofline (%):
the larger of QK^T and PV's operations at the bf16 peak and q, k, v and the
output's bytes at the memory rate (yardstick_eva), over the device time of
the kernels of kernels/eva_attn/. Nothing when no such kernel ran."""


def read(ctx):
    from portbench import yardstick_eva as Y

    seconds = ctx.kernel_seconds("eva_attn")
    if seconds <= 0:
        return None
    w = ctx.work
    bound = Y.attention_bound_s(ctx.cfg, w["images"] * w["passes"], 2, Y.PEAK_BF16_FLOPS)
    return 100.0 * bound / seconds

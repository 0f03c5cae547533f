"""The EVA02-E full blocks' attention cores in bf16 on heads of 112 against
their roofline (%): the larger of QK^T and PV's operations at the bf16 peak
and q, k, v and the output's bytes at the memory rate, both from 112-wide
heads (yardstick_evae), over the device time of the kernels of
kernels/evae_attn/. Nothing when no such kernel ran."""


def read(ctx):
    from portbench import yardstick_evae as Y

    seconds = ctx.kernel_seconds("evae_attn")
    if seconds <= 0:
        return None
    w = ctx.work
    bound = Y.attention_bound_s(ctx.cfg, w["images"] * w["passes"], 2, Y.PEAK_BF16_FLOPS)
    return 100.0 * bound / seconds

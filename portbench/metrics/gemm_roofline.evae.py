"""The EVA02-E full blocks' four bf16 products (qkv, the attention output,
fc1 with the exact GELU, fc2) against their roofline (%): the least time the
shapes allow at the card's bf16 and memory peaks (yardstick_evae), over the
device time of the kernels of kernels/evae_gemm/ (the post-norm residual
passes among them: their bytes are the implementation's, not the shapes').
Nothing when no such kernel ran."""


def read(ctx):
    from portbench import yardstick_evae as Y

    seconds = ctx.kernel_seconds("evae_gemm")
    if seconds <= 0:
        return None
    w = ctx.work
    bound = Y.block_gemm_bound_s(ctx.cfg, w["images"] * w["passes"], 2, Y.PEAK_BF16_FLOPS)
    return 100.0 * bound / seconds

"""The EVA02 full blocks' four bf16 products (qkv with RoPE, the attention
output with its sub-LN and residual, gate | up with SwiGLU, down with the
sub-LN and residual) against their roofline (%): the least time the shapes
allow at the card's bf16 and memory peaks (yardstick_eva), over the device
time of the kernels of kernels/eva_gemm/ (the MLP sub-LN's pass among them:
its bytes are the implementation's, not the shapes'). Nothing when no such
kernel ran."""


def read(ctx):
    from portbench import yardstick_eva as Y

    seconds = ctx.kernel_seconds("eva_gemm")
    if seconds <= 0:
        return None
    w = ctx.work
    bound = Y.block_gemm_bound_s(ctx.cfg, w["images"] * w["passes"], 2, Y.PEAK_BF16_FLOPS)
    return 100.0 * bound / seconds

"""Model FLOP/s of the traced training window against the card's peak for
fp32-accurate products, three TF32 passes (%): three times the forward's
FLOPs from the shapes (forward and backward; the backward's recompute not
counted) per image of every step, over the window's length."""


def read(ctx):
    y, w = ctx.yardstick, ctx.work
    flops = 3.0 * w["steps"] * w["batch"] * y.vision_forward_flops(ctx.cfg, ctx.cfg["n_cls"])
    return 100.0 * flops / ctx.trace.window_s / y.PEAK_FP32_ACCURATE_FLOPS

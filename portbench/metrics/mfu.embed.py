"""Model FLOP/s of the traced embedding window against the card's bf16 peak
(%): the forward's FLOPs from the configuration's shapes, once per pass
(two with flip-TTA) of every image embedded, over the window's length."""


def read(ctx):
    y, w = ctx.yardstick, ctx.work
    flops = w["images"] * w["passes"] * y.vision_forward_flops(ctx.cfg)
    return 100.0 * flops / ctx.trace.window_s / y.PEAK_BF16_FLOPS

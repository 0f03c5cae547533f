"""Model FLOP/s of the traced EVA02-E embedding window against the card's
bf16 peak (%): the forward's FLOPs from the configuration's shapes
(yardstick_evae), once per pass (two with flip-TTA) of every image
embedded, over the window's length."""


def read(ctx):
    from portbench import yardstick_evae as Y

    w = ctx.work
    flops = w["images"] * w["passes"] * Y.vision_forward_flops(ctx.cfg)
    return 100.0 * flops / ctx.trace.window_s / Y.PEAK_BF16_FLOPS

"""The whole step's share of the card's bf16 peak: the model FLOP of one
step (3 × the forward for training, the remat's recompute not counted)
over the window's mean step time, taken without the profiler."""


def read(ctx):
    w = ctx.window
    if w["units"] <= 0:
        return None
    return 100.0 * w["flops_per_unit"] * w["units"] / (
        w["window_s"] * ctx.roofline.PEAK_FLOPS["bfloat16"])

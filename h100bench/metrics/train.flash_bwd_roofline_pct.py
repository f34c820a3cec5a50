"""Flash attention's backward at its bound: 10·d FLOP an unmasked pair at
the bf16 peak, over the device time of the backward's kernels."""


def read(ctx):
    t = ctx.trace.device_s("flash_bwd")
    if t <= 0:
        return None
    return 100.0 * ctx.trace.units * ctx.profiled[
        "flash_bwd_flops_per_unit"] / ctx.roofline.PEAK_FLOPS["bfloat16"] / t

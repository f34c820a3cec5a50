"""The selective scan's backward at its bound (one exp an element on the
special-function units, or its bytes), over its kernels' device time."""


def read(ctx):
    t = ctx.trace.device_s("ssm_scan_bwd")
    if t <= 0:
        return None
    return 100.0 * ctx.trace.units * ctx.profiled[
        "scan_bwd_bound_s_per_unit"] / t

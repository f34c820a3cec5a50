"""The encode's share of its bound: one batch's two encodes' bytes at the
memory rate, over the device time of the ``poly_encode`` kernels in the
profiled batches."""


def read(ctx):
    t = ctx.trace.device_s("poly_encode")
    if t <= 0:
        return None
    return 100.0 * ctx.profiled["batches"] * ctx.profiled[
        "encode_bound_s"] / t

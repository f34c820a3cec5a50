"""The worker products' share of their bound: one batch's products as
the frozen roofline counts them (float32 as three TF32 passes), over the
device time of the ``coded_matmul`` kernels in the profiled batches."""


def read(ctx):
    t = ctx.trace.device_s("coded_matmul")
    if t <= 0:
        return None
    return 100.0 * ctx.profiled["batches"] * ctx.profiled[
        "products_bound_s"] / t

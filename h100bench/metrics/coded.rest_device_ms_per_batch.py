"""Device ms a batch outside the worker products and the encode: the
backend's casts, the decode's pushes and recombines, the scheduler's
device work."""


def read(ctx):
    tr = ctx.trace
    if tr.busy_s <= 0:
        return None
    rest = tr.busy_s - tr.device_s("coded_matmul") - tr.device_s(
        "poly_encode")
    return 1e3 * rest / ctx.profiled["batches"]

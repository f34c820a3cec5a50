"""Device ms a step in PyTorch's elementwise and reduction passes and
copies: every kernel that is not flash, the scan or a library GEMM."""


def read(ctx):
    tr = ctx.trace
    if tr.busy_s <= 0:
        return None
    return 1e3 * tr.by_kind().get("elementwise_other", 0.0) / tr.units

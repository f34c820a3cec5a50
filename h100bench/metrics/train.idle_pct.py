"""The share of the profiled window in which no operation ran on the
device (its busy time is the union of the kernels' intervals)."""
from h100bench import traces


def read(ctx):
    return traces.idle_pct(ctx.trace)

"""Device idle ms a batch in the gaps that open while the host is in a
blocking transfer: the innermost program span open at the gap's start is
a ``sync.*`` span."""
from h100bench import program_spans


def read(ctx):
    return program_spans.idle_ms_per_unit(ctx.trace, "sac.batch", ("sync",))

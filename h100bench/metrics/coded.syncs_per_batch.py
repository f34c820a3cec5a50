"""Transfers a batch that block the host: the ``sync.*`` spans in the
profiled window's trace, one around each."""
from h100bench import program_spans


def read(ctx):
    return program_spans.count_per_unit(ctx.trace, "sac.batch", ("sync",))

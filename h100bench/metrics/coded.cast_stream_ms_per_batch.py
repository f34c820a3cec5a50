"""Stream ms a batch of the backend's casts: the ``sac.cast`` spans (the
requests' float32 stacks, and the encoded operands' fold to the products'
dtype), from their timing events.  A stream interval, not busy time."""
from h100bench import program_spans


def read(ctx):
    return program_spans.stream_ms_per_unit(ctx.trace, "sac.batch",
                                            ("sac.cast",))

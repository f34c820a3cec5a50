"""Stream ms a step of the loss's forward: the ``train.forward`` span,
from its timing events.  A stream interval, not busy time."""
from h100bench import program_spans


def read(ctx):
    return program_spans.stream_ms_per_unit(ctx.trace, "train.step",
                                            ("train.forward",))

"""Stream ms a batch of the decode: the ``sac.decode`` span over the
batch's event loop (each completion's pushes, with their widening copies
and rank-1 updates, each deadline's resolves, recombines and β-scaled
estimates), from its timing events.  A stream interval, not busy time:
it holds the idle of the host-bound loop."""
from h100bench import program_spans


def read(ctx):
    return program_spans.stream_ms_per_unit(ctx.trace, "sac.batch",
                                            ("sac.decode",))
